"""The port's paged serving engine (paddle_tpu_torch.inference.paged) held
against the JAX package's PagedServingEngine on the same weights: greedy
tokens are identical with prefix sharing on, off, and in an undersized pool
that forces preemption. Plus the port's own pool, scheduler and engine
contracts (sampling invariance, COW, spill round trip, truncation)."""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.paged import PagedServingEngine as JaxPagedEngine
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt3_tiny as jax_tiny
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.inference import create_serving_engine
from paddle_tpu_torch.inference.paged import (
    BlockPool,
    PagedServingEngine,
    TwoQueueScheduler,
    prefix_page_key,
)
from paddle_tpu_torch.inference.serving import GenerationRequest
from paddle_tpu_torch.models import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.ops import decode_attention as port_da
from paddle_tpu_torch.ops import fused_norm as port_norm
from paddle_tpu_torch.observability import metrics

MAX_NEW = 6
PS = 8  # page size: 14-token prompts span two pages


@pytest.fixture(autouse=True)
def _fresh_registry():
    """The serving families are process-wide (the observability registry,
    as the reference's): each test reads its own engines' counts from a
    fresh registry."""
    metrics.reset_default_registry()
    yield


def _prompts():
    """Four 14-token prompts; 0 and 2 share their first page (8 tokens)."""
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 1000, PS).astype(np.int32)
    out = []
    for i in range(4):
        if i % 2 == 0:
            out.append(np.concatenate(
                [shared, rng.integers(1, 1000, 6).astype(np.int32)]))
        else:
            out.append(rng.integers(1, 1000, 14).astype(np.int32))
    return out


def _drive(eng, prompts, temps=None, priorities=None):
    ids = [eng.add_request(
        p, max_new_tokens=MAX_NEW,
        temperature=0.0 if temps is None else temps[i],
        priority=0 if priorities is None else priorities[i])
        for i, p in enumerate(prompts)]
    by = {r.req_id: r for r in eng.run()}
    return [by[i] for i in ids]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(jax_tiny())
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu")
    load_paddle_tpu_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def jax_greedy(models):
    """Greedy tokens of the JAX engine (its Pallas decode kernel in interpret
    mode, as the conftest fixture sets it up for a single test)."""
    jm, _ = models
    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        eng = JaxPagedEngine(jm, max_batch_size=4, max_seq_len=64,
                             page_size=PS, seed=3)
        return [r.generated for r in _drive(eng, _prompts())]


ENGINES = {
    "sharing_on": dict(),
    "sharing_off": dict(prefix_sharing=False),
    # 4 prompts x 2 pages admit into 9 usable pages; growing past 16 tokens
    # wants 4 more pages, so decode must spill requests and resume them
    "preempting_pool": dict(num_pages=10, watermark_pages=0,
                            prefix_sharing=False),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_greedy_tokens_match_jax_engine(models, jax_greedy, name):
    _, tm = models
    eng = create_serving_engine(tm, max_batch_size=4, max_seq_len=64,
                                page_size=PS, seed=3, **ENGINES[name])
    got = _drive(eng, _prompts(), priorities=[0, -1, -2, -3])
    assert [r.generated for r in got] == jax_greedy
    assert all(len(r.generated) == MAX_NEW for r in got)
    m = eng.metrics
    if name == "sharing_on":
        assert m["prefix_hits"].value() > 0
    else:
        assert m["prefix_hits"].value() == 0
    if name == "preempting_pool":
        assert m["preemptions"].value() > 0 and m["resumes"].value() > 0
    assert port_da.LAUNCHES == 0 and port_norm.LAUNCHES == 0


def test_sampled_tokens_do_not_depend_on_scheduling(models):
    """Each request samples from its own generator seeded by (seed,
    arrival index): sharing on/off and preemption give the same tokens."""
    _, tm = models
    temps = [0.7, 0.0, 0.9, 0.0]
    outs = []
    for kw in ENGINES.values():
        eng = PagedServingEngine(tm, max_batch_size=4, max_seq_len=64,
                                 page_size=PS, seed=11, **kw)
        outs.append([r.generated for r in _drive(eng, _prompts(), temps,
                                                 [0, -1, -2, -3])])
    assert outs[0] == outs[1] == outs[2]


def test_identical_prompts_share_pages_then_copy_on_write(models):
    _, tm = models
    eng = PagedServingEngine(tm, max_batch_size=4, max_seq_len=64,
                             page_size=16, seed=3)
    prompt = np.random.default_rng(1).integers(1, 1000, 10).astype(np.int32)
    eng.add_request(prompt, max_new_tokens=4)
    eng.add_request(prompt, max_new_tokens=4)
    out = eng.run()
    assert out[0].generated == out[1].generated
    assert eng.metrics["cow_copies"].value() > 0
    assert eng.pool.allocs_total == 2  # one shared prompt page + one COW copy


def test_truncation_is_flagged_and_counted(models):
    _, tm = models
    eng = PagedServingEngine(tm, max_batch_size=2, max_seq_len=16,
                             page_size=8)
    eng.add_request(np.arange(1, 11, dtype=np.int32), max_new_tokens=100)
    done = eng.run()
    assert done[0].truncated and len(done[0].generated) == 6  # 16 - 10
    assert eng.metrics["truncations"].value(engine="paged") == 1
    assert eng.metrics["tokens"].value(engine="paged") == 6
    assert eng.metrics["ttft"].count(engine="paged") == 1


def test_add_request_validation(models):
    _, tm = models
    eng = PagedServingEngine(tm, max_batch_size=2, max_seq_len=16,
                             page_size=8, num_pages=2)  # 1 usable page
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.add_request(np.zeros(16, np.int32))
    with pytest.raises(ValueError, match="pages"):
        eng.add_request(np.zeros(10, np.int32), max_new_tokens=4)


def test_unported_options_raise(models):
    """What stays unported raises: MMHA's quant, beam and rotary
    arguments. The int8 KV pool, `kv_quant`, `serve_w8` and the dense
    engine are ported (tests/test_torch_serving_quant.py,
    tests/test_torch_dense_serving.py)."""
    from paddle_tpu_torch.incubate.nn.functional import (
        masked_multihead_attention,
    )

    _, tm = models
    x, cache = torch.zeros(1, 48), torch.zeros(2, 1, 2, 4, 8)
    with pytest.raises(NotImplementedError, match="quant"):
        masked_multihead_attention(x, cache, out_scale=0.5)
    with pytest.raises(NotImplementedError, match="rotary"):
        masked_multihead_attention(x, cache, rotary_tensor=torch.zeros(1))
    assert BlockPool(1, 1, 4, 4, 3, quantized=True, device="cpu").quantized
    assert create_serving_engine(tm, paged=False).engine_label == "dense"


class TestBlockPool:
    def _pool(self, **kw):
        args = dict(num_layers=1, kv_heads=1, head_dim=4, page_size=4,
                    num_pages=5, device="cpu")
        args.update(kw)
        return BlockPool(**args)

    def test_alloc_free_cycle_never_hands_out_null_page(self):
        pool = self._pool()
        assert pool.pages_total == 4
        got = [pool.alloc() for _ in range(4)]
        assert 0 not in got and pool.alloc() is None
        for p in got:
            pool.release(p)
        assert pool.pages_free == 4

    def test_refcounted_prefix_sharing_and_unregister(self):
        pool = self._pool()
        key = prefix_page_key(np.arange(4, dtype=np.int32), 0, 4)
        p = pool.alloc()
        pool.register_prefix(key, p)
        assert pool.lookup_prefix(key) == p and pool.is_shared(p)
        pool.release(p)
        assert not pool.is_shared(p) and pool.is_registered(p)
        pool.unregister_page(p)
        assert pool.lookup_prefix(key) is None
        assert pool.metrics["prefix_hits"].value() == 1
        assert pool.metrics["prefix_lookups"].value() == 2

    def test_spill_roundtrip_and_copy_are_bitwise(self):
        pool = self._pool(num_layers=2)
        rng = np.random.default_rng(0)
        for k, v in pool.kv:
            k.copy_(torch.from_numpy(rng.standard_normal(k.shape).astype(np.float32)))
            v.copy_(torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)))
        host = pool.read_pages([2, 3])
        pool.restore_pages([4, 1], host, [1, 0])  # logical 1 -> 4, 0 -> 1
        for (k, v), (kh, vh) in zip(pool.kv, host):
            assert torch.equal(k[4], kh[1]) and torch.equal(v[1], vh[0])
        pool.copy_page(2, 3)
        assert all(torch.equal(k[3], k[2]) for k, _ in pool.kv)
        assert pool.metrics["cow_copies"].value() == 1


class TestScheduler:
    def _req(self, n):
        return GenerationRequest(np.ones(n, np.int32), max_new_tokens=2)

    def test_watermark_blocks_head_of_line(self):
        s = TwoQueueScheduler(page_size=4, watermark_pages=2)
        big, small = self._req(16), self._req(2)  # 4 pages, 1 page
        s.enqueue_prefill(big)
        s.enqueue_prefill(small)
        assert s.pick(free_rows=4, pages_free=5, live=1) == []
        assert s.pick(free_rows=4, pages_free=7, live=1) == [big, small]

    def test_fifo_across_buckets(self):
        s = TwoQueueScheduler(page_size=4)
        reqs = [self._req(n) for n in (40, 3, 20)]
        for r in reqs:
            s.enqueue_prefill(r)
        assert s.pick(free_rows=8, pages_free=100, live=0) == reqs
