"""The port's GPT-3 decoder (paddle_tpu_torch.models.gpt) held against the
JAX package's on the same weights, carried across by
`load_paddle_tpu_state`: full-sequence logits, the dense-cache prefill
(logits and caches) and one paged decode step (logits and the written
pages). The JAX side runs its Pallas kernels in interpret mode. Also the
port's own rules: it imports neither JAX nor the JAX package, and its
entry points refuse to run without a GPU unless asked for the CPU."""

import ast
import importlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.jit import functional_call
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt3_tiny as jax_tiny
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.models import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.ops import decode_attention as port_da
from paddle_tpu_torch.ops import fused_norm as port_norm

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(jax_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=1)
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    load_paddle_tpu_state(tm, state)
    tm.eval()
    return jm, tm


# f32 on both sides; matmuls, norms and softmaxes sum in different orders
# (and the JAX side's attention is the Pallas flash kernel's unshifted
# softmax), so logits of magnitude ~0.3 agree to a few 1e-6
TOL = dict(rtol=1e-4, atol=1e-5)


def _jt(a):
    return Tensor(jnp.asarray(a))


def test_full_sequence_logits_match_jax(models):
    jm, tm = models
    ids = np.random.default_rng(0).integers(0, 1024, (2, 16)).astype(np.int32)
    want = jm(_jt(ids)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    assert got.shape == (2, 16, 1024)
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_logits_and_caches_match_jax(models):
    """Batch-1 prefill over a zeroed 32-slot dense cache at offset 0 (the
    engine's bucketed prefill): 13 prompt tokens plus padding."""
    jm, tm = models
    Sp, n = 32, 13
    ids = np.zeros((1, Sp), np.int32)
    ids[0, :n] = np.random.default_rng(1).integers(1, 1024, n)
    pos = np.arange(Sp, dtype=np.int32)[None]
    j_logits, j_caches = jm(_jt(ids), _jt(pos), jm.init_kv_caches(1, Sp),
                            _jt(np.int32(0)))
    with torch.no_grad():
        t_logits, t_caches = tm(torch.from_numpy(ids).long(),
                                torch.from_numpy(pos).long(),
                                tm.init_kv_caches(1, Sp), 0)
    np.testing.assert_allclose(t_logits.numpy(), j_logits.numpy(), **TOL)
    for (jk, jv), (tk, tv) in zip(j_caches, t_caches):
        np.testing.assert_allclose(tk.numpy(), jk.numpy(), **TOL)
        np.testing.assert_allclose(tv.numpy(), jv.numpy(), **TOL)


def _jax_paged_step(jm, tok, pos, pool, lengths, tables):
    """The JAX engine's decode program: the model under jax.jit through
    functional_call (the Pallas interpreter needs the traced form)."""
    params = {k: p._value for k, p in jm.named_parameters()}

    def fwd(p, tok, pos, caches, off, tabs):
        c = [tuple(Tensor(x) for x in layer) for layer in caches]
        (logits, new_c), _ = functional_call(
            jm, p, {}, [Tensor(tok), Tensor(pos), c, Tensor(off)],
            kwargs={"block_tables": Tensor(tabs)}, train=False)
        return logits, new_c

    logits, new_c = jax.jit(fwd)(
        params, jnp.asarray(tok), jnp.asarray(pos),
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in pool],
        jnp.asarray(lengths), jnp.asarray(tables))
    return np.asarray(logits), [(np.asarray(k), np.asarray(v))
                                for k, v in new_c]


def test_paged_decode_step_matches_jax(models):
    """One fixed-shape decode step over a paged pool: two live rows at
    lengths 10 and 21 (one on a fresh page boundary case, one mid-page)
    and a parked row (table all -1, length 0) that must write the null
    page and read zeros."""
    jm, tm = models
    cfg = jm.config
    rng = np.random.default_rng(2)
    ps, P, n_pages = 8, 4, 9
    shape = (n_pages, cfg.kv_heads, ps, cfg.head_dim)
    pool = [(rng.standard_normal(shape).astype(np.float32),
             rng.standard_normal(shape).astype(np.float32))
            for _ in range(cfg.num_layers)]
    tables = np.full((3, P), -1, np.int32)
    tables[0, :2] = [3, 1]
    tables[1, :3] = [2, 5, 7]
    lengths = np.asarray([10, 21, 0], np.int32)
    tok = np.asarray([[5], [77], [0]], np.int32)
    pos = lengths[:, None]

    j_logits, j_new = _jax_paged_step(jm, tok, pos, pool, lengths, tables)
    t_pool = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
              for k, v in pool]
    with torch.no_grad():
        t_logits, t_new = tm(torch.from_numpy(tok).long(),
                             torch.from_numpy(pos).long(), t_pool,
                             torch.from_numpy(lengths),
                             block_tables=torch.from_numpy(tables))
    np.testing.assert_allclose(t_logits.numpy(), j_logits, **TOL)
    for (jk, jv), (tk, tv), (k0, _) in zip(j_new, t_new, t_pool):
        assert tk is k0  # the pool was written in place
        np.testing.assert_allclose(tk.numpy(), jk, **TOL)
        np.testing.assert_allclose(tv.numpy(), jv, **TOL)
    assert port_da.LAUNCHES == 0 and port_norm.LAUNCHES == 0


def test_load_paddle_tpu_state_rejects_mismatches(models):
    jm, _ = models
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu")
    bad = dict(state)
    bad.pop("gpt.final_norm.bias")
    with pytest.raises(KeyError, match="final_norm.bias"):
        load_paddle_tpu_state(tm, bad)
    bad = dict(state, **{"gpt.extra.weight": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="extra"):
        load_paddle_tpu_state(tm, bad)
    bad = dict(state)
    bad["gpt.layers.0.mlp.fc1.weight"] = bad["gpt.layers.0.mlp.fc1.weight"].T
    with pytest.raises(ValueError, match="fc1.weight"):
        load_paddle_tpu_state(tm, bad)
    # dtype is cast to the port's parameters
    tb = GPTForCausalLM(gpt3_tiny(), device="cpu", dtype=torch.bfloat16)
    load_paddle_tpu_state(tb, state)
    w = tb.gpt.layers[1].self_attn.q_proj.weight
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.detach().float().numpy(),
        torch.tensor(state["gpt.layers.1.self_attn.q_proj.weight"])
        .to(torch.bfloat16).float().numpy())


def test_unported_branches_raise():
    """A pipelined model under context parallelism is still to port, and
    attention dropout on the flashmask variant raises as the reference
    asserts; the LLaMA form, flashmask attention, sequence parallelism,
    context parallelism and dropout now build (tests/test_torch_llama.py,
    tests/test_torch_tensor_parallel.py, tests/test_torch_ring_attention.py,
    tests/test_torch_random.py); without a mesh a context-parallel model's
    attention is the dense one, so its logits are the plain model's, and
    in eval mode a model with dropout gives the plain model's too."""
    from paddle_tpu_torch.models import GPTForCausalLMPipe

    with pytest.raises(ValueError, match="attention dropout"):
        GPTForCausalLM(gpt3_tiny(attention_dropout_prob=0.1,
                                 attn_variant="flashmask"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GPTForCausalLMPipe(gpt3_tiny(context_parallel=True), device="cpu")
    for kw in (dict(use_rope=True), dict(attn_variant="flashmask"),
               dict(sequence_parallel=True)):
        GPTForCausalLM(gpt3_tiny(**kw), device="cpu")
    ids = torch.randint(0, 1024, (2, 16), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        cp = GPTForCausalLM(gpt3_tiny(context_parallel=True), device="cpu")(ids)
        plain = GPTForCausalLM(gpt3_tiny(), device="cpu")(ids)
        dropped = GPTForCausalLM(gpt3_tiny(hidden_dropout_prob=0.1,
                                           attention_dropout_prob=0.1),
                                 device="cpu").eval()(ids)
    torch.testing.assert_close(cp, plain, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dropped, plain, rtol=0, atol=0)


def test_entry_points_without_device_raise_without_a_gpu(monkeypatch):
    """Without a GPU, asking for the default device raises rather than
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from paddle_tpu_torch.inference.paged import BlockPool
    from paddle_tpu_torch.nn import LayerNorm

    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(gpt3_tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LayerNorm(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlockPool(1, 1, 4, 4, 3)


def _port_modules():
    pkg = importlib.import_module("paddle_tpu_torch")
    import pkgutil

    return [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                  "paddle_tpu_torch.")]


def test_import_loads_no_jax_and_no_jax_package():
    """A fresh interpreter importing every module of the port ends with no
    jax*, no paddle_tpu and no paddle_tpu.* module loaded."""
    assert {"paddle_tpu_torch.ops.fused_rope", "paddle_tpu_torch.ops.masked_flash",
            "paddle_tpu_torch.models.llama",
            "paddle_tpu_torch.incubate.nn.functional",
            "paddle_tpu_torch.ops.grouped_gemm",
            "paddle_tpu_torch.incubate.distributed.models.moe.gate",
            "paddle_tpu_torch.incubate.distributed.models.moe.moe_layer",
            "paddle_tpu_torch.nn.functional.extras",
            "paddle_tpu_torch.nn.clip", "paddle_tpu_torch.distributed.env",
            "paddle_tpu_torch.distributed.collective",
            "paddle_tpu_torch.distributed.train_step",
            "paddle_tpu_torch.distributed.parallel",
            "paddle_tpu_torch.distributed.sharding",
            "paddle_tpu_torch.distributed.fleet",
            "paddle_tpu_torch.distributed.fleet.base.topology",
            "paddle_tpu_torch.distributed.fleet.base.distributed_strategy",
            "paddle_tpu_torch.distributed.fleet.meta_optimizers",
            "paddle_tpu_torch.distributed.fleet.meta_parallel",
            "paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers",
            "paddle_tpu_torch.distributed.fleet.utils.sequence_parallel_utils",
            "paddle_tpu_torch.parallel.pipeline",
            "paddle_tpu_torch.models.gpt_pipe",
            "paddle_tpu_torch.distributed.fleet.meta_parallel.pp_layers",
            "paddle_tpu_torch.distributed.fleet.meta_parallel.pipeline_parallel",
            "paddle_tpu_torch.distributed.fleet.meta_parallel.tensor_parallel",
            "paddle_tpu_torch.parallel.ring",
            "paddle_tpu_torch.distributed.fleet.meta_parallel.segment_parallel",
            "paddle_tpu_torch.distributed.moe_comm",
            "paddle_tpu_torch.distributed.utils",
            "paddle_tpu_torch.distributed.utils.moe_utils",
            "paddle_tpu_torch.nn.layer.transformer",
            "paddle_tpu_torch.nn.layer.conv",
            "paddle_tpu_torch.nn.layer.pooling",
            "paddle_tpu_torch.nn.functional.conv",
            "paddle_tpu_torch.nn.functional.pooling",
            "paddle_tpu_torch.models.bert",
            "paddle_tpu_torch.vision.models.resnet",
            "paddle_tpu_torch.vision.models._blocks",
            "paddle_tpu_torch.models.unet",
            "paddle_tpu_torch.nn.layer.loss",
            "paddle_tpu_torch.framework.random",
            "paddle_tpu_torch.optimizer.lr",
            "paddle_tpu_torch.optimizer.lbfgs",
            "paddle_tpu_torch.observability",
            "paddle_tpu_torch.observability.metrics",
            "paddle_tpu_torch.observability.spans",
            "paddle_tpu_torch.observability.flight",
            "paddle_tpu_torch.profiler",
            "paddle_tpu_torch.profiler.profiler",
            "paddle_tpu_torch.profiler.statistic",
            "paddle_tpu_torch.profiler.timer",
            "paddle_tpu_torch.framework.native",
            "paddle_tpu_torch.distributed.comm_watchdog",
            "paddle_tpu_torch.distributed.faults",
            "paddle_tpu_torch.distributed.checkpoint",
            "paddle_tpu_torch.distributed.checkpoint.metadata",
            "paddle_tpu_torch.distributed.checkpoint.save_state_dict",
            "paddle_tpu_torch.distributed.checkpoint.load_state_dict",
            "paddle_tpu_torch.distributed.checkpoint.manager",
            "paddle_tpu_torch.distributed.store",
            "paddle_tpu_torch.distributed.launch",
            "paddle_tpu_torch.distributed.launch.main",
            "paddle_tpu_torch.distributed.launch.__main__",
            "paddle_tpu_torch.distributed.fleet.elastic",
            "paddle_tpu_torch.distributed.fleet.elastic.manager",
            "paddle_tpu_torch.distributed.resilience",
            "paddle_tpu_torch.distributed.rpc",
            "paddle_tpu_torch.distributed.eager_multiproc",
            } <= set(
                _port_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib') or n == 'paddle_tpu' or n.startswith('paddle_tpu.'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_telemetry_and_checkpoint_import_alone_without_jax():
    """The telemetry, the profiler, the watchdog, the checkpoint and the
    resilient runtime (the launcher, the store, the elastic manager,
    resilience, rpc, eager_multiproc), each imported first in a fresh
    interpreter, load no jax and nothing of the JAX package (its
    pure-Python observability, faults, checkpoint metadata, store, rpc and
    native loader included: the port keeps its own copies), and the
    watchdog's and the store's host library builds from the port's own
    sources."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch.observability\n"
        "import paddle_tpu_torch.profiler\n"
        "import paddle_tpu_torch.distributed.comm_watchdog as wd\n"
        "import paddle_tpu_torch.distributed.checkpoint\n"
        "import paddle_tpu_torch.distributed.launch.main\n"
        "import paddle_tpu_torch.distributed.fleet.elastic\n"
        "import paddle_tpu_torch.distributed.resilience\n"
        "import paddle_tpu_torch.distributed.rpc\n"
        "import paddle_tpu_torch.distributed.eager_multiproc\n"
        "from paddle_tpu_torch.distributed.store import TCPStore\n"
        "from paddle_tpu_torch.framework import native\n"
        "assert str(native.HOST_SRC).endswith('paddle_tpu_torch/csrc/host')\n"
        "assert wd.enable(60.0) and wd.timeout_count() == 0\n"
        "wd.disable()\n"
        "st = TCPStore('127.0.0.1', 0, is_master=True)\n"
        "st.set('k', b'v')\n"
        "assert st.get('k') == b'v'\n"
        "st.close()\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib') or n == 'paddle_tpu' or n.startswith('paddle_tpu.'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_no_port_file_names_jax_in_an_import():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "chip_ranks.py",
        ROOT / "tests" / "torch_dist_worker.py",
        ROOT / "tests" / "torch_tp_cases.py",
        ROOT / "tests" / "torch_pp_cases.py",
        ROOT / "tests" / "torch_sep_cases.py",
        ROOT / "tests" / "torch_ep_cases.py",
        ROOT / "tests" / "torch_model_dp_cases.py",
        ROOT / "tests" / "torch_random_cases.py",
        ROOT / "tests" / "torch_eager_cases.py"]
    offenders = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "paddle_tpu"):
                    offenders.append(f"{f.relative_to(ROOT)}: {n}")
    assert not offenders, offenders
