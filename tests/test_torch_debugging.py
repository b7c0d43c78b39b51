"""The port's amp.debugging against paddle_tpu's: the 5 tests of
tests/test_debugging.py run on the port (the tensor checker, its warn mode
and skip list, check_numerics, the operator statistics, the device memory
statistics), and the op list of gpt3_tiny's forward and backward under
`collect_operator_stats()` in both packages: every op name the reference
lists is in the port's list, or stands in `DIFFERENCES` with its reason."""

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.amp.debugging import (
    DebugMode,
    NumericError,
    TensorCheckerConfig,
    check_numerics,
    collect_operator_stats,
    disable_tensor_checker,
    enable_tensor_checker,
    operator_stats,
)
from paddle_tpu_torch.framework import core


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield
    paddle.device._default = "cuda"


def test_tensor_checker_aborts_on_nan():
    cfg = TensorCheckerConfig(enable=True,
                              debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT)
    enable_tensor_checker(cfg)
    try:
        x = paddle.to_tensor(np.array([1.0, 0.0], np.float32))
        with pytest.raises(NumericError, match="divide"):
            _ = x / paddle.to_tensor(np.array([1.0, 0.0], np.float32))
    finally:
        disable_tensor_checker()
    # the hook is gone: the same op no longer raises
    assert core.op_check_hook() is None
    bad = x / paddle.to_tensor(np.array([1.0, 0.0], np.float32))
    assert not np.isfinite(bad.numpy()).all()


def test_tensor_checker_warn_mode_and_skip_list():
    cfg = TensorCheckerConfig(enable=True, debug_mode=DebugMode.CHECK_NAN_INF,
                              skipped_op_list={"divide"})
    enable_tensor_checker(cfg)
    try:
        x = paddle.to_tensor(np.array([1.0], np.float32))
        z = paddle.to_tensor(np.array([0.0], np.float32))
        _ = x / z  # a skipped op: no warning, no raise
        with pytest.warns(UserWarning, match="log"):
            _ = paddle.log(z - 1.0)
    finally:
        disable_tensor_checker()


def test_check_numerics():
    t = paddle.to_tensor(np.array([1.0, np.nan, np.inf, 0.0], np.float32))
    with pytest.raises(NumericError):
        check_numerics(t, "op", "t")
    n_nan, n_inf, n_zero = check_numerics(t, "op", "t",
                                          debug_mode=DebugMode.CHECK_NAN_INF)
    assert (int(n_nan), int(n_inf), int(n_zero)) == (1, 1, 1)


def test_collect_operator_stats(capsys):
    with collect_operator_stats():
        x = paddle.to_tensor(np.ones((4, 4), np.float32))
        _ = paddle.matmul(x, x)
        _ = x + x
        stats = operator_stats()
    assert "matmul" in stats and "add" in stats
    assert any("float32" in dt for dt in stats["matmul"])
    out = capsys.readouterr().out
    assert "op list" in out and "matmul" in out
    assert core.op_check_hook() is None


def test_device_memory_stats():
    """The counters the reference's test reads; on the CPU torch keeps no
    allocator statistics, so they read 0 there (device.py)."""
    import paddle_tpu_torch.device as device

    base = device.memory_allocated()
    x = paddle.to_tensor(np.ones((256, 256), np.float32))
    allocated = device.memory_allocated()
    assert allocated >= base
    assert device.max_memory_allocated() >= allocated
    stats = device.memory_stats()
    assert "bytes_in_use" in stats and "peak_bytes_in_use" in stats
    device.reset_max_memory_allocated()
    assert device.max_memory_allocated() <= device.memory_allocated() + 1
    del x


# the reference's op names of gpt3_tiny's step that the port's list lacks
DIFFERENCES = {
    "sdpa": "the reference's attention on the CPU is its composite `sdpa` "
            "(its flash kernel route runs on the TPU only); the port's runs "
            "the flash kernel's wrapper (its plain version on a CPU tensor) "
            "and reports `flash_attention`",
    "add": "a residual add inside the decoder layer's forward: a torch op of "
           "the port's model code, which does not pass through the Paddle API",
    "reshape": "the heads' reshapes inside the attention's forward: torch "
               "ops of the model code, as `add`",
    "mean": "the criterion's mean is a torch op of the model code, as `add`",
}


def _ref_ops():
    from paddle_tpu.amp.debugging import collect_operator_stats as ref_collect
    from paddle_tpu.amp.debugging import operator_stats as ref_stats
    from paddle_tpu.models import GPTForCausalLM, GPTPretrainingCriterion, gpt3_tiny

    from paddle_tpu.distributed import env as ref_env

    ref.seed(0)
    m = GPTForCausalLM(gpt3_tiny())
    crit = GPTPretrainingCriterion()
    ids = ref.to_tensor(np.random.default_rng(0).integers(0, 1024, (2, 16)))
    # one device, whatever global mesh an earlier test of this process left
    # set (the reference's model adds sharding_constraint ops under one)
    prev = ref_env.get_global_mesh()
    ref_env.set_global_mesh(None)
    try:
        with ref_collect():
            crit(m(ids), ids).backward()
            return set(ref_stats())
    finally:
        ref_env.set_global_mesh(prev)


def _port_ops():
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_tiny)

    m = GPTForCausalLM(gpt3_tiny())
    crit = GPTPretrainingCriterion()
    ids = paddle.to_tensor(np.random.default_rng(0).integers(0, 1024, (2, 16)))
    with collect_operator_stats():
        crit(m(ids), ids).backward()
        return operator_stats()


def test_gpt3_tiny_op_list_holds_the_reference_names():
    ref_ops = _ref_ops()
    port = _port_ops()
    missing = ref_ops - set(port)
    assert missing == set(DIFFERENCES), (missing, sorted(port))
    # the kernels' wrappers report under the reference's names, their
    # backwards as <name>_grad: forward and backward both ran
    for name in ("flash_attention", "flash_attention_grad", "layer_norm",
                 "layer_norm_grad", "linear", "embedding", "gelu",
                 "lm_head_tied", "cross_entropy"):
        assert port.get(name), name
    # two layers: two attentions, five norms (two a layer and the last)
    assert port["flash_attention"] == {"float32": 2}
    assert port["layer_norm"] == {"float32": 5}
    assert port["layer_norm_grad"] == {"float32": 5}
