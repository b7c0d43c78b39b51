"""The port's quantized serving (int8 KV pages with `kv_quant=True`,
weight-only int8 projections with `serve_w8=True`) held against the JAX
package's on the same weights, plus the port's own invariants of
tests/test_serving_quant.py::TestQuantEngine: bounded logit distance to
the full-precision engine, bitwise preemption invariance, prefix sharing
and COW under quantization, more concurrency at an equal byte budget, and
the budget errors."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.paged import BlockPool as JaxBlockPool
from paddle_tpu.inference.paged import PagedServingEngine as JaxPagedEngine
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt3_tiny as jax_tiny
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.inference.paged import BlockPool, PagedServingEngine
from paddle_tpu_torch.models import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.ops import decode_attention as port_da
from paddle_tpu_torch.quantization import QuantizedLinear, ptq_convert_for_serving
from paddle_tpu_torch.observability import metrics

PS = 16
MAX_NEW = 5
# the two engines share the weights, the int8 pages (bitwise: the same
# quantizer on the same f32 K/V up to a few ulps) and the f32 logit path;
# their products sum in other orders
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _fresh_registry():
    """The serving families are process-wide (the observability registry,
    as the reference's): each test reads its own engines' counts from a
    fresh registry."""
    metrics.reset_default_registry()
    yield


def _prompts():
    rng = np.random.default_rng(42)
    return [rng.integers(1, 1000, 4 + 3 * i).astype(np.int32)
            for i in range(4)]


def _jax_model():
    paddle.seed(0)
    return JaxGPT(jax_tiny())


def _first_tick_and_tokens(eng, prompts, **kw):
    """Add every prompt, run one tick (admission and the first decode
    step), keep its logits, then drain: (logits [B, V] numpy, greedy
    tokens per request in arrival order)."""
    ids = [eng.add_request(p, max_new_tokens=MAX_NEW, **kw) for p in prompts]
    eng.step()
    first = eng.last_logits
    first = (first.float().numpy() if torch.is_tensor(first)
             else np.asarray(first, np.float32))
    by = {r.req_id: r for r in eng.run()}
    return first, [by[i].generated for i in ids]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine (Pallas kernels in interpret mode) with int8 KV, and
    with int8 KV and int8 weights, on one set of weights; plus the port
    model loaded from the unconverted JAX model."""
    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        jm = _jax_model()
        state = {k: v.numpy() for k, v in jm.state_dict().items()}
        kv = _first_tick_and_tokens(
            JaxPagedEngine(jm, max_batch_size=4, max_seq_len=64,
                           page_size=PS, seed=3, kv_quant=True), _prompts())
        jw = _jax_model()
        eng = JaxPagedEngine(jw, max_batch_size=4, max_seq_len=64,
                             page_size=PS, seed=3, kv_quant=True,
                             serve_w8=True)
        w8 = _first_tick_and_tokens(eng, _prompts())
        w8_state = {k: v.numpy() for k, v in jw.state_dict().items()}
    return {"state": state, "kv": kv, "w8": w8, "w8_state": w8_state}


def _port(jax_runs):
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu")
    return load_paddle_tpu_state(tm, jax_runs["state"])


# --------------------------------------------------------------------------- #
# against the JAX package
# --------------------------------------------------------------------------- #


def test_kv_quant_engine_matches_jax(jax_runs):
    eng = PagedServingEngine(_port(jax_runs), max_batch_size=4,
                             max_seq_len=64, page_size=PS, seed=3,
                             kv_quant=True)
    first, toks = _first_tick_and_tokens(eng, _prompts())
    want_first, want_toks = jax_runs["kv"]
    assert toks == want_toks
    np.testing.assert_allclose(first, want_first, rtol=0, atol=LOGIT_TOL)
    assert eng.pool.kv[0][0].dtype == torch.int8
    assert eng.metrics["kv_quant_pages"].value() > 0
    assert port_da.Q8_LAUNCHES == 0 and port_da.LAUNCHES == 0


def test_serve_w8_weights_are_bitwise_and_tokens_match_jax(jax_runs):
    tm = _port(jax_runs)
    eng = PagedServingEngine(tm, max_batch_size=4, max_seq_len=64,
                             page_size=PS, seed=3, kv_quant=True,
                             serve_w8=True)
    assert eng.serve_w8 and eng.kv_dtype == torch.float32
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    want = jax_runs["w8_state"]
    assert sorted(state) == sorted(want)
    quant = [k for k in want if k.endswith("weight_quant")]
    assert len(quant) == 12  # 6 projections x 2 layers; embeddings stay f32
    for k in want:
        assert state[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(state[k], np.asarray(want[k]), err_msg=k)
    first, toks = _first_tick_and_tokens(eng, _prompts())
    want_first, want_toks = jax_runs["w8"]
    assert toks == want_toks
    np.testing.assert_allclose(first, want_first, rtol=0, atol=LOGIT_TOL)


def test_load_converted_jax_state_into_converted_port_model(jax_runs):
    tm = _port(jax_runs)
    ptq_convert_for_serving(tm)
    tm.load_state_dict({k: torch.zeros_like(v)
                        for k, v in tm.state_dict().items()})
    load_paddle_tpu_state(tm, jax_runs["w8_state"])
    q = tm.gpt.layers[1].mlp.fc2
    assert isinstance(q, QuantizedLinear)
    np.testing.assert_array_equal(
        q.weight_quant.numpy(),
        jax_runs["w8_state"]["gpt.layers.1.mlp.fc2.weight_quant"])
    assert q.weight_scale.shape == (1, 64) and q.weight_scale.dtype == torch.float32


@pytest.mark.parametrize("dims", [(2, 2, 4, 4), (12, 12, 64, 16), (24, 16, 128, 32)])
def test_pool_layout_and_bytes_equal_jax(dims):
    L, Hkv, D, ps = dims
    for quantized in (False, True):
        want = JaxBlockPool.page_nbytes(L, Hkv, D, ps, jnp.float32, quantized)
        assert BlockPool.page_nbytes(L, Hkv, D, ps, torch.float32,
                                     quantized) == want
    assert BlockPool.page_nbytes(L, Hkv, D, ps, torch.bfloat16) == \
        JaxBlockPool.page_nbytes(L, Hkv, D, ps, jnp.bfloat16)
    pool = BlockPool(2, 2, 4, 4, 6, quantized=True, device="cpu")
    jpool = JaxBlockPool(2, 2, 4, 4, 6, quantized=True)
    assert pool.kv[0][0].dtype == torch.int8 and pool.kv[0][0].shape == (6, 2, 4, 4)
    assert pool.scales[0][0].shape == (6, 2)
    assert pool.scales[0][0].dtype == torch.float32
    assert pool.bytes_per_page == jpool.bytes_per_page
    assert pool.bytes_per_token == jpool.bytes_per_token


def test_prompt_pages_quantize_like_jax_and_move_bitwise():
    """write_prompt_pages quantizes exactly as the JAX pool does; COW and a
    spill/restore round trip carry payload and scales bit for bit."""
    rng = np.random.default_rng(0)
    stacked = rng.standard_normal((2, 2, 4, 4)).astype(np.float32) * 2.0
    pool = BlockPool(2, 2, 4, 4, 6, quantized=True, device="cpu")
    jpool = JaxBlockPool(2, 2, 4, 4, 6, quantized=True)
    pages = [pool.alloc(), pool.alloc()]
    assert pages == [jpool.alloc(), jpool.alloc()]
    pool.write_prompt_pages(pages, [True, True], [torch.from_numpy(stacked)] * 2,
                            [torch.from_numpy(-stacked)] * 2)
    jpool.write_prompt_pages(pages, [True, True], [jnp.asarray(stacked)] * 2,
                             [jnp.asarray(-stacked)] * 2)
    for li in range(2):
        for side in range(2):
            np.testing.assert_array_equal(pool.kv[li][side].numpy(),
                                          np.asarray(jpool.kv[li][side]))
            np.testing.assert_array_equal(pool.scales[li][side].numpy(),
                                          np.asarray(jpool.scales[li][side]))
    assert pool.metrics["kv_quant_pages"].value() == 2
    dst = pool.alloc()
    pool.copy_page(pages[0], dst)
    before = [t.clone() for t in pool.cache_layers()[1]]
    host = pool.read_pages(pages)
    assert len(host[0]) == 4 and host[0][0].device.type == "cpu"
    for p in pages:
        pool.release(p)
    for t in pool.cache_layers()[1]:
        t[pages] = 0  # the next tenant overwrites the released pages
    fresh = [pool.alloc(), pool.alloc()]
    pool.restore_pages(fresh, host, [0, 1])
    for t, b in zip(pool.cache_layers()[1], before):
        torch.testing.assert_close(t[fresh], b[pages], rtol=0, atol=0)
        torch.testing.assert_close(t[dst], b[pages[0]], rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# the port's own invariants (tests/test_serving_quant.py::TestQuantEngine)
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def port_model():
    torch.manual_seed(0)
    return GPTForCausalLM(gpt3_tiny(), device="cpu", seed=0)


def test_logit_and_token_divergence_vs_full_precision(port_model):
    """Lockstep int8-KV vs f32 engines on a mixed greedy/sampled workload:
    first-tick logits (pure KV quantization error after an identical
    prefill) within 0.02, every tick's within 0.05, tokens identical."""
    rng = np.random.default_rng(42)
    prompts = [rng.integers(1, 1000, 4 + i).astype(np.int32) for i in range(4)]
    temps = [0.0, 0.7, 0.0, 0.0]
    engines = {q: PagedServingEngine(port_model, max_batch_size=4,
                                     max_seq_len=64, page_size=16, seed=3,
                                     kv_quant=q) for q in (False, True)}
    for eng in engines.values():
        for p, t in zip(prompts, temps):
            eng.add_request(p, max_new_tokens=5, temperature=t)
    diffs = []
    while engines[False].has_work() or engines[True].has_work():
        engines[False].step()
        engines[True].step()
        diffs.append((engines[False].last_logits
                      - engines[True].last_logits).abs().max().item())
    assert 0 < diffs[0] <= 0.02
    assert max(diffs) <= 0.05
    toks = {q: [r.generated for r in sorted(e.finished, key=lambda r: r.req_id)]
            for q, e in engines.items()}
    assert toks[True] == toks[False]


def test_preemption_recovery_is_bitwise_invariant(port_model):
    """An undersized int8 pool that forces spill and resume gives the same
    tokens as an ample one: page content is a function of page history,
    and the spill round-trips exactly."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 1000, 14).astype(np.int32) for _ in range(4)]

    def run(**kw):
        eng = PagedServingEngine(port_model, max_batch_size=4, max_seq_len=64,
                                 page_size=16, seed=3, kv_quant=True,
                                 prefix_sharing=False, **kw)
        ids = [eng.add_request(p, max_new_tokens=6, priority=-i)
               for i, p in enumerate(prompts)]
        by = {r.req_id: r for r in eng.run()}
        return [by[i].generated for i in ids], eng.metrics

    ample, _ = run()
    starved, m = run(num_pages=6, watermark_pages=0)
    assert m["preemptions"].value() > 0 and m["resumes"].value() > 0
    assert starved == ample


def test_prefix_sharing_and_cow_under_kv_quant(port_model):
    eng = PagedServingEngine(port_model, max_batch_size=4, max_seq_len=64,
                             page_size=16, seed=3, kv_quant=True)
    prompt = np.random.default_rng(1).integers(1, 1000, 10).astype(np.int32)
    eng.add_request(prompt, max_new_tokens=4)
    eng.add_request(prompt, max_new_tokens=4)
    done = sorted(eng.run(), key=lambda r: r.req_id)
    assert done[0].generated == done[1].generated
    assert eng.metrics["prefix_hits"].value() > 0
    assert eng.metrics["cow_copies"].value() > 0


def test_more_concurrency_than_f32_at_equal_byte_budget(port_model):
    cfg = gpt3_tiny()
    budget = 13 * BlockPool.page_nbytes(cfg.num_layers, cfg.kv_heads,
                                        cfg.head_dim, 16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 1000, 30).astype(np.int32) for _ in range(8)]
    peak = {}
    for quant in (False, True):
        eng = PagedServingEngine(port_model, max_batch_size=8, max_seq_len=64,
                                 page_size=16, seed=0, kv_quant=quant,
                                 kv_budget_bytes=budget)
        for p in prompts:
            eng.add_request(p, max_new_tokens=3)
        peak[quant] = 0
        while eng.has_work():
            eng.step()
            peak[quant] = max(peak[quant], eng.live_count)
        if quant:
            assert eng.metrics["kv_bytes_per_token"].value() < 512
    assert peak[True] == 8 and peak[True] > peak[False]


def test_byte_budget_errors(port_model):
    with pytest.raises(ValueError, match="kv_budget_bytes"):
        PagedServingEngine(port_model, max_batch_size=2, max_seq_len=32,
                           page_size=16, kv_budget_bytes=64)
    with pytest.raises(ValueError, match="not both"):
        PagedServingEngine(port_model, max_batch_size=2, max_seq_len=32,
                           page_size=16, num_pages=100,
                           kv_budget_bytes=200_000)


def test_serve_w8_convert_is_idempotent_and_skips_heads():
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=1)
    dense = sum(t.numel() * t.element_size() for t in tm.state_dict().values())
    assert ptq_convert_for_serving(tm) == 12
    assert ptq_convert_for_serving(tm) == 0
    assert not any(k.endswith("proj.weight") or k.endswith("fc1.weight")
                   for k in tm.state_dict())
    assert tm.gpt.embed_tokens.weight.dtype == torch.float32
    served = sum(t.numel() * t.element_size() for t in tm.state_dict().values())
    assert served < dense
    # an untied head named lm_head stays full precision, as in the JAX pass
    from paddle_tpu_torch.nn import Linear

    head = torch.nn.Module()
    head.proj = Linear(8, 8, device="cpu")
    head.lm_head = Linear(8, 16, device="cpu")
    assert ptq_convert_for_serving(head) == 1
    assert isinstance(head.proj, QuantizedLinear) and isinstance(head.lm_head, Linear)
