"""The port's incubate `block_multihead_attention`, `blha_get_max_len` and
`variable_length_memory_efficient_attention` held against the JAX
package's (mirroring tests/test_inference.py:98-314), and chip_smoke.py's
block-attention decoder (phase 26) on `llama_tiny`, held against the same
decoder built from the JAX functionals and against the port model's own
logits.

Cases: a prefill then a decode step (MHA and GQA, a qkv bias, a mixed
prefill/decode batch, -1 table entries), int8 pages with per-head scales
(the pages equal, bit for bit), RoPE at the absolute positions (neox and
interleaved), a shared prefix cache, and the options the JAX package
accepts and never reads (`mask`, `tgt_mask`), which raise here. A decode
step without int8 pages or a prefix goes through
`ops.decode_attention.paged_decode_attention` (its plain version on CPU
tensors), every other case through the composite; the JAX decode step
runs its Pallas paged kernel in interpret mode. f32, values within
1e-5."""

import pathlib
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as jax_if
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.incubate.nn import functional as port_if
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


@pytest.fixture
def paged_calls(monkeypatch):
    """Counts the port's calls of the paged decode route."""
    calls = []
    real = port_if.paged_decode_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(port_if, "paged_decode_attention", spy)
    return calls


def _both(jfn_kw, tfn_kw, *arrays, **kw):
    """The JAX and the port call on the same numpy `arrays` (positional)
    and keyword arrays `kw` (None passes through)."""
    j = jax_if.block_multihead_attention(
        *[paddle.to_tensor(a) for a in arrays],
        **{k: (None if v is None else paddle.to_tensor(v))
           for k, v in kw.items()}, **jfn_kw)
    t = port_if.block_multihead_attention(
        *[torch.from_numpy(np.array(a)) for a in arrays],
        **{k: (None if v is None else torch.from_numpy(np.array(v)))
           for k, v in kw.items()}, **tfn_kw)
    return j, t


def _caches(n, hkv, bs, d, dtype=np.float32):
    return np.zeros((n, hkv, bs, d), dtype), np.zeros((n, hkv, bs, d), dtype)


def _lens(*vals):
    return np.asarray(vals, np.int32)


# name: (Hq, Hkv, with a qkv bias)
HEADS = {"mha": (2, 2, False), "gqa_bias": (4, 2, True)}


@pytest.mark.parametrize("name", list(HEADS))
def test_prefill_then_decode_match_jax(name, paged_calls):
    """A prefill (rows of 5 and 3 tokens, padded to 5) and a decode step
    of both rows; the caches the port wrote in place equal the JAX
    package's returned ones, and the decode step took the paged route."""
    hq, hkv, with_bias = HEADS[name]
    rng = np.random.default_rng(0)
    B, D, bs, S = 2, 8, 4, 5
    w = (hq + 2 * hkv) * D
    kc, vc = _caches(8, hkv, bs, D)
    tables = np.array([[0, 1, -1, -1], [2, 3, -1, -1]], np.int32)
    bias = rng.standard_normal(w).astype(np.float32) if with_bias else None
    kw = dict(block_tables=tables, qkv_bias=bias)
    qkv = rng.standard_normal((B, S, w)).astype(np.float32)
    enc = _lens(5, 3)
    (jo, jq, jk, jv), (to, tq, tk, tv) = _both(
        dict(block_size=bs), dict(block_size=bs), qkv, kc, vc, enc,
        _lens(0, 0), enc, **kw)
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)
    np.testing.assert_array_equal(tk.numpy(), jk.numpy())
    np.testing.assert_array_equal(tv.numpy(), jv.numpy())
    np.testing.assert_array_equal(tq.numpy(), jq.numpy())
    assert not paged_calls
    qkv_d = rng.standard_normal((B, 1, w)).astype(np.float32)
    (jo, _, jk, jv), (to, _, tk2, tv2) = _both(
        dict(block_size=bs), dict(block_size=bs), qkv_d, jk.numpy(),
        jv.numpy(), _lens(0, 0), enc, _lens(1, 1), **kw)
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)
    np.testing.assert_array_equal(tk2.numpy(), jk.numpy())
    np.testing.assert_array_equal(tv2.numpy(), jv.numpy())
    assert paged_calls == [(B, hq, D)]


def test_caches_written_in_place():
    rng = np.random.default_rng(1)
    kc = torch.zeros(4, 1, 4, 8)
    vc = torch.zeros(4, 1, 4, 8)
    qkv = torch.from_numpy(rng.standard_normal((1, 3, 24)).astype(np.float32))
    n3 = torch.tensor([3], dtype=torch.int32)
    out, _, k2, v2 = port_if.block_multihead_attention(
        qkv, kc, vc, n3, torch.zeros(1, dtype=torch.int32), n3,
        block_tables=torch.tensor([[2, 0]], dtype=torch.int32), block_size=4)
    assert k2 is kc and v2 is vc
    torch.testing.assert_close(kc[2, 0, :3], qkv.reshape(3, 3, 8)[:, 1])
    assert kc[2, 0, 3].abs().max() == 0 and kc[0].abs().max() == 0


def test_mixed_batch_and_unused_pages_match_jax():
    """One call with a prefill row (4 tokens), a decode row (7 cached, the
    S - 1 padded positions' writes dropped) and a row whose second page is
    -1; the decode row's window crosses into its second page."""
    rng = np.random.default_rng(2)
    B, hq, hkv, D, bs, S = 3, 4, 2, 8, 4, 4
    w = (hq + 2 * hkv) * D
    kc = rng.standard_normal((10, hkv, bs, D)).astype(np.float32)
    vc = rng.standard_normal((10, hkv, bs, D)).astype(np.float32)
    tables = np.array([[0, 1, 2], [3, 4, 5], [6, -1, -1]], np.int32)
    qkv = rng.standard_normal((B, S, w)).astype(np.float32)
    enc, dec = _lens(4, 0, 3), _lens(0, 7, 0)
    (jo, _, jk, jv), (to, _, tk, tv) = _both(
        dict(block_size=bs), dict(block_size=bs), qkv, kc, vc, enc, dec,
        _lens(4, 1, 3), block_tables=tables)
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)
    np.testing.assert_array_equal(tk.numpy(), jk.numpy())
    np.testing.assert_array_equal(tv.numpy(), jv.numpy())


def _q8_args(rng, hkv, amax):
    qs = np.full((hkv,), 127.0 / amax, np.float32)
    dqs = (1.0 / qs).astype(np.float32)
    return dict(cache_k_quant_scales=qs, cache_v_quant_scales=qs,
                cache_k_dequant_scales=dqs, cache_v_dequant_scales=dqs)


def test_int8_pages_equal_and_outputs_match_jax(paged_calls):
    """The int8 page path (tests/test_inference.py:134): prefill and a
    decode step; the int8 pages equal the JAX package's bit for bit (round
    half to even, clip to [-128, 127]); the decode step stays on the
    composite; the f32-page result is within the reference test's bound."""
    rng = np.random.default_rng(3)
    B, hq, hkv, D, bs, S = 2, 4, 2, 8, 4, 5
    qkv = rng.standard_normal((B, S, (hq + 2 * hkv) * D)).astype(np.float32)
    tables = np.array([[0, 1, -1, -1], [2, 3, -1, -1]], np.int32)
    q8 = _q8_args(rng, hkv, np.abs(qkv).max())
    enc = _lens(S, S)
    kc8, vc8 = _caches(8, hkv, bs, D, np.int8)
    (jo, _, jk, jv), (to, _, tk, tv) = _both(
        dict(block_size=bs), dict(block_size=bs), qkv, kc8, vc8, enc,
        _lens(0, 0), enc, block_tables=tables, **q8)
    assert tk.dtype == torch.int8 and tk.abs().max() > 0
    np.testing.assert_array_equal(tk.numpy(), jk.numpy())
    np.testing.assert_array_equal(tv.numpy(), jv.numpy())
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)
    kc, vc = _caches(8, hkv, bs, D)
    ref = port_if.block_multihead_attention(
        torch.from_numpy(qkv), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(enc), torch.zeros(B, dtype=torch.int32),
        torch.from_numpy(enc), block_tables=torch.from_numpy(tables),
        block_size=bs)[0]
    assert (to - ref).abs().max() < 0.05 * ref.abs().max() + 1e-2
    qkv_d = rng.standard_normal((B, 1, (hq + 2 * hkv) * D)).astype(np.float32)
    (jo, _, jk, _), (to, _, tk, _) = _both(
        dict(block_size=bs), dict(block_size=bs), qkv_d, jk.numpy(),
        jv.numpy(), _lens(0, 0), enc, _lens(1, 1), block_tables=tables,
        **q8)
    np.testing.assert_array_equal(tk.numpy(), jk.numpy())
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)
    assert not paged_calls


def test_partial_quant_scales_raise_in_both():
    x = np.zeros((1, 1, 24), np.float32)
    kc, vc = _caches(2, 1, 4, 8, np.int8)
    for fn, conv in ((jax_if.block_multihead_attention, paddle.to_tensor),
                     (port_if.block_multihead_attention,
                      lambda a: torch.from_numpy(np.array(a)))):
        with pytest.raises(ValueError):
            fn(conv(x), conv(kc), conv(vc), conv(_lens(1)), conv(_lens(0)),
               conv(_lens(1)), block_tables=conv(np.zeros((1, 2), np.int32)),
               cache_k_quant_scales=conv(np.ones(1, np.float32)))


def _rope_table(B, max_seq, D):
    inv = 1.0 / (10000.0 ** (np.arange(0, D, 2) / D))
    ang = np.arange(max_seq)[:, None] * inv[None, :]
    rope = np.stack([np.cos(ang), np.sin(ang)])[:, None, :, None, :]
    return np.broadcast_to(rope, (2, B, max_seq, 1, D // 2)).astype(np.float32)


@pytest.mark.parametrize("neox", [True, False])
def test_rope_at_absolute_positions_matches_jax(neox, paged_calls):
    """rope_emb rotates q and the new k at their absolute positions before
    the write (tests/test_inference.py:173): a prefill and a decode step,
    the rotated keys in the pages."""
    rng = np.random.default_rng(5)
    B, hq, hkv, D, bs, S = 2, 2, 2, 8, 4, 4
    w = (hq + 2 * hkv) * D
    rope = _rope_table(B, 16, D)
    tables = np.array([[0, 1, -1, -1], [2, 3, -1, -1]], np.int32)
    kw = dict(block_size=bs, use_neox_style=neox)
    kc, vc = _caches(8, hkv, bs, D)
    qkv = rng.standard_normal((B, S, w)).astype(np.float32)
    enc = _lens(S, 3)
    (jo, _, jk, jv), (to, _, tk, tv) = _both(
        kw, kw, qkv, kc, vc, enc, _lens(0, 0), enc, block_tables=tables,
        rope_emb=rope)
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)
    np.testing.assert_allclose(tk.numpy(), jk.numpy(), **TOL)
    qkv_d = rng.standard_normal((B, 1, w)).astype(np.float32)
    (jo, _, jk, _), (to, _, tk, _) = _both(
        kw, kw, qkv_d, tk.numpy(), tv.numpy(), _lens(0, 0), enc, _lens(1, 1),
        block_tables=tables, rope_emb=rope[:, :1])
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)
    np.testing.assert_allclose(tk.numpy(), jk.numpy(), **TOL)
    assert len(paged_calls) == 1


def test_prefix_cache_prefill_and_decode_match_jax(paged_calls):
    """pre_key_cache / pre_value_cache (tests/test_inference.py:223, :257):
    every query of a live row attends the prefix before the pages; a
    decode step with a prefix stays on the composite."""
    rng = np.random.default_rng(7)
    B, hq, hkv, D, bs, S, P = 2, 4, 2, 8, 4, 4, 3
    w = (hq + 2 * hkv) * D
    pre_k = rng.standard_normal((B, hkv, P, D)).astype(np.float32)
    pre_v = rng.standard_normal((B, hkv, P, D)).astype(np.float32)
    tables = np.array([[0, 1, -1, -1], [2, 3, -1, -1]], np.int32)
    kc, vc = _caches(8, hkv, bs, D)
    qkv = rng.standard_normal((B, S, w)).astype(np.float32)
    enc = _lens(S, 2)
    pre = dict(pre_key_cache=pre_k, pre_value_cache=pre_v)
    kw = dict(block_size=bs)
    (jo, _, jk, jv), (to, _, tk, tv) = _both(
        kw, kw, qkv, kc, vc, enc, _lens(0, 0), enc, block_tables=tables,
        **pre)
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)
    qkv_d = rng.standard_normal((B, 1, w)).astype(np.float32)
    (jo, _, _, _), (to, _, _, _) = _both(
        kw, kw, qkv_d, tk.numpy(), tv.numpy(), _lens(0, 0), enc, _lens(1, 1),
        block_tables=tables, **pre)
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)
    assert not paged_calls


def test_blha_get_max_len_matches_jax():
    e, d = np.array([3, 9, 1], np.int32), np.array([5, 2, 8], np.int32)
    je, jd = jax_if.blha_get_max_len(paddle.to_tensor(e), paddle.to_tensor(d))
    te, td = port_if.blha_get_max_len(torch.from_numpy(e), torch.from_numpy(d))
    assert te.tolist() == [9] == je.numpy().tolist()
    assert td.tolist() == [8] == jd.numpy().tolist()


def test_unread_options_raise():
    """The JAX package accepts `mask` and `tgt_mask` and never reads them
    (paddle_tpu/incubate/nn/functional/__init__.py:698-800): the port
    raises on them, as on the activation-quant arguments (which the JAX
    package refuses too)."""
    x = torch.zeros(1, 1, 24)
    kc = torch.zeros(2, 1, 4, 8)
    n = torch.ones(1, dtype=torch.int32)
    args = (x, kc, kc.clone(), n, n * 0, n)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    for bad in (dict(mask=torch.zeros(1, 1, 1, 8)),
                dict(tgt_mask=torch.zeros(1, 1, 1, 8)),
                dict(qkv_out_scale=torch.ones(24))):
        with pytest.raises(NotImplementedError):
            port_if.block_multihead_attention(*args, block_tables=tables,
                                              block_size=4, **bad)
    # the JAX package runs with the mask and ignores it
    jargs = [paddle.to_tensor(a.numpy()) for a in args]
    j0 = jax_if.block_multihead_attention(
        *jargs, block_tables=paddle.to_tensor(tables.numpy()), block_size=4)[0]
    j1 = jax_if.block_multihead_attention(
        *jargs, block_tables=paddle.to_tensor(tables.numpy()), block_size=4,
        mask=paddle.to_tensor(np.full((1, 1, 1, 8), -1e9, np.float32)))[0]
    np.testing.assert_array_equal(j0.numpy(), j1.numpy())


# name: (causal, additive mask, scale)
VARLEN = {"padded": (False, False, None), "causal": (True, False, None),
          "causal_mask_scale": (True, True, 0.3)}


@pytest.mark.parametrize("name", list(VARLEN))
def test_variable_length_attention_matches_jax(name):
    """[B, H, S, D] with per-row lengths (tests/test_inference.py:301):
    keys past kv_seq_lens dropped, causal bottom-right per row."""
    causal, with_mask, scale = VARLEN[name]
    rng = np.random.default_rng(11)
    B, H, Sq, Sk, D = 3, 2, 6, 8, 4
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    ql, kl = _lens(6, 4, 2), _lens(8, 5, 3)
    mask = (rng.standard_normal((B, 1, Sq, Sk)).astype(np.float32)
            if with_mask else None)
    kw = dict(scale=scale, causal=causal)
    j = jax_if.variable_length_memory_efficient_attention(
        *[paddle.to_tensor(a) for a in (q, k, v, ql, kl)],
        mask=None if mask is None else paddle.to_tensor(mask), **kw)
    t = port_if.variable_length_memory_efficient_attention(
        *[torch.from_numpy(a) for a in (q, k, v, ql, kl)],
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(t.numpy(), j.numpy(), **TOL)


# --------------------------------------------------------------------------- #
# chip_smoke.py's phase 26 decoder on llama_tiny
# --------------------------------------------------------------------------- #

PROMPTS = [[5, 9, 100, 7, 3], list(range(10, 19)), list(range(200, 214))]
DEC_BLOCK, DEC_TICKS = 8, 3


@pytest.fixture(scope="module")
def llama():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(), device="cpu", seed=1)
    load_paddle_tpu_state(tm, state)
    return state, tm


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _jax_decoder_logits(state, cfg, prompts, tokens, bs):
    """The phase 26 decoder written with the JAX functionals on the same
    weights: the prefill's logits, then one tick's per fed token row."""
    W = {k: paddle.to_tensor(v) for k, v in state.items()}

    def cat(*names):
        return paddle.to_tensor(np.concatenate([state[n] for n in names], 1))

    pre = "gpt.layers.{}."
    layers = [dict(
        ln1=W[pre.format(i) + "input_layernorm.weight"],
        wqkv=cat(*[pre.format(i) + f"self_attn.{p}_proj.weight"
                   for p in "qkv"]),
        wo=W[pre.format(i) + "self_attn.out_proj.weight"],
        ln2=W[pre.format(i) + "post_attention_layernorm.weight"],
        wgu=cat(pre.format(i) + "mlp.gate_proj.weight",
                pre.format(i) + "mlp.up_proj.weight"),
        wd=W[pre.format(i) + "mlp.down_proj.weight"])
        for i in range(cfg.num_layers)]
    B, D = len(prompts), cfg.head_dim
    P = -(-(max(map(len, prompts)) + len(tokens) + 2) // bs)
    tables = paddle.to_tensor(np.arange(B * P, dtype=np.int32).reshape(B, P))
    caches = [[paddle.to_tensor(np.zeros((B * P, cfg.kv_heads, bs, D),
                                         np.float32)) for _ in range(2)]
              for _ in layers]
    cos, sin = jax_if._rope_tables(P * bs, D, cfg.rope_theta, np.float32)
    rope = paddle.to_tensor(np.stack([np.asarray(cos), np.asarray(sin)])
                            [:, :, :, None, :])
    emb = state["gpt.embed_tokens.weight"]
    eps = cfg.layer_norm_epsilon

    def run(ids, enc, dec):
        h = paddle.to_tensor(emb[ids])
        this = np.where(enc > 0, enc, 1).astype(np.int32)
        for w, c in zip(layers, caches):
            y, _ = jax_if.fused_rms_norm(h, w["ln1"], epsilon=eps)
            out, _, c[0], c[1] = jax_if.block_multihead_attention(
                jax_if.fused_linear(y, w["wqkv"]), c[0], c[1],
                paddle.to_tensor(enc), paddle.to_tensor(dec),
                paddle.to_tensor(this), block_tables=tables, rope_emb=rope,
                block_size=bs, use_neox_style=cfg.use_neox_rotary_style)
            y, h = jax_if.fused_rms_norm(jax_if.fused_linear(out, w["wo"]),
                                         w["ln2"], epsilon=eps, residual=h)
            a = jax_if.fused_bias_act(jax_if.fused_linear(y, w["wgu"]),
                                      act_method="swiglu")
            h = h + jax_if.fused_linear(a, w["wd"])
        return jax_if.fused_rms_norm(h, W["gpt.final_norm.weight"],
                                     epsilon=eps)[0].numpy()

    S = max(map(len, prompts))
    ids = np.zeros((B, S), np.int64)
    for b, p in enumerate(prompts):
        ids[b, :len(p)] = p
    enc = np.asarray([len(p) for p in prompts], np.int32)
    h = run(ids, enc, np.zeros(B, np.int32))
    head = state["lm_head.weight"]
    out = [h[np.arange(B), enc - 1] @ head]
    lens = enc.copy()
    for tok in tokens:
        h = run(np.asarray(tok, np.int64)[:, None], np.zeros(B, np.int32),
                lens)
        lens = lens + 1
        out.append(h[:, 0] @ head)
    return out


def test_phase26_decoder_matches_model_and_jax_functionals(llama):
    """BlockAttentionDecoder on llama_tiny (pages of 8, three prompts of
    5, 9 and 14 tokens, a prefill and three greedy ticks): every step's
    logits within 1e-5 of the port model's own forward over the whole
    sequence so far and of the same decoder on the JAX functionals."""
    state, tm = llama
    cs = _chip_smoke()
    dec = cs.BlockAttentionDecoder(torch, tm, len(PROMPTS), 32,
                                   block_size=DEC_BLOCK)
    with torch.no_grad():
        logits = [dec.prefill(PROMPTS)]
        toks = []
        for _ in range(DEC_TICKS):
            toks.append(logits[-1].argmax(-1))
            logits.append(dec.tick(toks[-1]))
        seqs = [list(p) for p in PROMPTS]
        for step, lg in enumerate(logits):
            for b, seq in enumerate(seqs):
                want = tm(torch.tensor([seq]))[0, -1]
                torch.testing.assert_close(lg[b], want, **TOL)
            if step < DEC_TICKS:
                for b, seq in enumerate(seqs):
                    seq.append(int(toks[step][b]))
    jl = _jax_decoder_logits(state, tm.config, PROMPTS,
                             [t.tolist() for t in toks], DEC_BLOCK)
    for got, want in zip(logits, jl):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
