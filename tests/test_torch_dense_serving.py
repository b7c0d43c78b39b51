"""The port's dense continuous-batching engine
(`create_serving_engine(paged=False)`) and `GPTForCausalLM.generate` held
against the JAX package's on the same weights (greedy tokens identical;
the JAX engine's decode runs its flash kernel in interpret mode, as the
port's decode routes its key-padding mask to the flash forward), plus the
port's own contracts of tests/test_serving.py and tests/test_inference.py:
a single request matches `generate`, EOS stops a request, a prompt too long
is refused, sampled rows leave greedy rows untouched, sampling is
reproducible per seed, capacity retirement is flagged."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JaxDense
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt3_tiny as jax_tiny
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.inference import ContinuousBatchingEngine, create_serving_engine
from paddle_tpu_torch.models import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.ops import flash_attention as port_fa
from paddle_tpu_torch.observability import metrics

PROMPT = np.array([5, 7, 11, 13], np.int32)


@pytest.fixture(autouse=True)
def _fresh_registry():
    """The serving families are process-wide (the observability registry,
    as the reference's): each test reads its own engines' counts from a
    fresh registry."""
    metrics.reset_default_registry()
    yield


def _staggered():
    """Six prompts of different lengths and budgets for four slots."""
    return [(np.arange(2 + i, dtype=np.int32) + 3, 4 + i % 3)
            for i in range(6)]


def _gen_ids():
    return np.random.RandomState(0).randint(1, 1000, (2, 8)).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(jax_tiny())
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu")
    load_paddle_tpu_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def jax_out(models):
    """Greedy tokens of the JAX dense engine under staggered admission and
    of its cached `generate`. Its no-cache `generate` runs eagerly, op by
    op (some 14 s here), and its own tests hold it equal to the cached one
    (tests/test_inference.py::TestGenerate), so the port's no-cache
    `generate` is held to the cached JAX tokens."""
    jm, _ = models
    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        eng = JaxDense(jm, max_batch_size=4, max_seq_len=64)
        ids = [eng.add_request(p, max_new_tokens=n, temperature=0.0)
               for p, n in _staggered()]
        by = {r.req_id: r for r in eng.run()}
        return {
            "engine": [by[i].generated for i in ids],
            "generate": jm.generate(_gen_ids(), max_new_tokens=6,
                                    temperature=0.0).numpy(),
        }


def test_dense_engine_matches_jax_under_staggered_admission(models, jax_out):
    _, tm = models
    eng = create_serving_engine(tm, paged=False, max_batch_size=4,
                                max_seq_len=64)
    assert isinstance(eng, ContinuousBatchingEngine)
    ids = [eng.add_request(p, max_new_tokens=n, temperature=0.0)
           for p, n in _staggered()]
    by = {r.req_id: r for r in eng.run()}
    assert [by[i].generated for i in ids] == jax_out["engine"]
    assert eng.metrics["requests"].value(engine="dense") == 6
    assert port_fa.FWD_LAUNCHES == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("use_cache", [True, False])
def test_generate_matches_jax(models, jax_out, use_cache):
    _, tm = models
    got = tm.generate(_gen_ids(), max_new_tokens=6, temperature=0.0,
                      use_cache=use_cache)
    assert got.shape == (2, 14)
    np.testing.assert_array_equal(got.numpy(), jax_out["generate"])


def test_bf16_generate_with_f32_caches_matches_jax(monkeypatch):
    """`generate` keeps f32 caches for a bf16 model in both packages: the
    prefill's composite promotes to f32, and the decode's flash route casts
    the caches to the query's bf16 (JAX `flash_attention_fwd` does the same,
    its kernel in interpret mode here). Greedy tokens are identical."""
    if os.environ.get("PADDLE_TPU_HW") != "1":
        monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    paddle.seed(0)
    jm = JaxGPT(jax_tiny())
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    for _, p in jm.named_parameters():
        p._value = p._value.astype(jnp.bfloat16)
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu", dtype=torch.bfloat16)
    load_paddle_tpu_state(tm, state)
    want = jm.generate(_gen_ids(), max_new_tokens=8, temperature=0.0).numpy()
    got = tm.generate(_gen_ids(), max_new_tokens=8, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_single_request_matches_generate(models):
    _, tm = models
    eng = create_serving_engine(tm, paged=False, max_batch_size=4,
                                max_seq_len=64)
    eng.add_request(PROMPT, max_new_tokens=8, temperature=0.0)
    done = eng.run()
    ref = tm.generate(PROMPT[None], max_new_tokens=8, temperature=0.0)
    np.testing.assert_array_equal(done[0].output_ids, ref.numpy()[0])


def test_eos_stops_request_and_generate(models):
    _, tm = models
    ref = tm.generate(PROMPT[None], max_new_tokens=8, temperature=0.0)
    eos = int(ref[0, len(PROMPT)])  # the first generated token acts as EOS
    eng = ContinuousBatchingEngine(tm, max_batch_size=2, max_seq_len=64)
    eng.add_request(PROMPT, max_new_tokens=8, eos_token_id=eos)
    assert eng.run()[0].generated == [eos]
    stopped = tm.generate(PROMPT[None], max_new_tokens=8, temperature=0.0,
                          eos_token_id=eos)
    assert stopped.shape == (1, len(PROMPT) + 1)


def test_prompt_too_long_rejected(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, max_batch_size=2, max_seq_len=16)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.add_request(np.zeros(16, np.int32))


def test_sampled_rows_leave_greedy_rows_untouched(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, max_batch_size=2, max_seq_len=64)
    g_only = eng.add_request(np.array([5, 7, 11], np.int32), max_new_tokens=4)
    ref = {r.req_id: r.generated for r in eng.run()}[g_only]
    eng = ContinuousBatchingEngine(tm, max_batch_size=2, max_seq_len=64)
    g = eng.add_request(np.array([5, 7, 11], np.int32), max_new_tokens=4)
    s = eng.add_request(np.array([2, 3], np.int32), max_new_tokens=4,
                        temperature=0.9)
    out = {r.req_id: r.generated for r in eng.run()}
    assert out[g] == ref and len(out[s]) == 4


def test_admission_is_online_and_truncation_flagged(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, max_batch_size=2, max_seq_len=64)
    a = eng.add_request(np.array([3, 4], np.int32), max_new_tokens=6)
    assert set(eng.step()) == {a}
    b = eng.add_request(np.array([9, 8, 7], np.int32), max_new_tokens=3)
    assert set(eng.step()) == {a, b}
    assert {r.req_id for r in eng.run()} == {a, b}
    eng = ContinuousBatchingEngine(tm, max_batch_size=2, max_seq_len=16)
    eng.add_request(np.arange(1, 11, dtype=np.int32), max_new_tokens=100)
    done = eng.run()
    assert done[0].truncated and len(done[0].generated) == 6  # 16 - 10
    assert eng.metrics["truncations"].value(engine="dense") == 1


def test_sampling_is_reproducible_per_seed(models):
    _, tm = models
    ids = np.random.RandomState(2).randint(0, 1000, (2, 4)).astype(np.int32)
    kw = dict(max_new_tokens=5, temperature=0.9, top_k=20, top_p=0.9)
    a = tm.generate(ids, seed=7, **kw)
    assert torch.equal(a, tm.generate(ids, seed=7, **kw))

    def engine_sample(seed):
        eng = ContinuousBatchingEngine(tm, max_batch_size=2, max_seq_len=64,
                                       seed=seed)
        eng.add_request(np.array([9, 8, 7], np.int32), max_new_tokens=5,
                        temperature=0.8)
        return eng.run()[0].generated

    assert engine_sample(5) == engine_sample(5)


def test_top_k_and_top_p_keep_only_their_tokens():
    from paddle_tpu_torch.models.generation import _sample

    logits = torch.tensor([[0.0, 1.0, 2.0, 3.0, 4.0]]).repeat(64, 1)
    gen = torch.Generator().manual_seed(0)
    assert set(_sample(logits, 1.0, 2, 1.0, gen).tolist()) <= {3, 4}
    # softmax of [0..4]: 0.64 on token 4, 0.24 on token 3 -> top_p 0.7 keeps both
    assert set(_sample(logits, 1.0, 0, 0.7, gen).tolist()) <= {3, 4}
    assert set(_sample(logits, 1.0, 0, 0.5, gen).tolist()) == {4}
    assert _sample(logits, 0.0, 0, 1.0, gen).tolist() == [4] * 64
