"""paddle.save / paddle.load across the two packages (a file written by
either loads in the other), flags, dtypes and the device defaults of the
port's framework core."""

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.framework import dtype as dtype_mod
from paddle_tpu_torch.framework import io as port_io


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.device._default = "cuda"


def _ref_gpt():
    from paddle_tpu.models import GPTForCausalLM, gpt3_tiny

    ref.seed(3)
    return GPTForCausalLM(gpt3_tiny())


def _port_gpt(seed):
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_tiny

    return GPTForCausalLM(gpt3_tiny(), seed=seed)


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    jm = _ref_gpt()
    path = str(tmp_path / "ref" / "gpt.pdparams")
    ref.save(jm.state_dict(), path)
    state = port.load(path)
    assert all(isinstance(v, port.Tensor) for v in state.values())
    m = _port_gpt(seed=11)
    missing, unexpected = m.set_state_dict(state)
    assert missing == [] and unexpected == []
    want = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    got = {k: v.numpy() for k, v in m.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_checkpoint_loads_into_the_reference(tmp_path):
    m = _port_gpt(seed=5)
    path = str(tmp_path / "port.pdparams")
    port.save(m.state_dict(), path)
    state = ref.load(path)
    jm = _ref_gpt()
    missing, unexpected = jm.set_state_dict(state)
    assert missing == [] and unexpected == []
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(np.asarray(jm.state_dict()[k].numpy()),
                                      v.numpy(), err_msg=k)


def test_nested_objects(tmp_path):
    path = str(tmp_path / "obj.pd")
    t = port.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    port.save({"t": t, "n": 3, "l": [t, (t, "x")]}, path)
    back = port.load(path)
    assert back["n"] == 3 and back["l"][1][1] == "x"
    np.testing.assert_array_equal(back["l"][1][0].numpy(), t.numpy())
    # the reference reads the same file
    np.testing.assert_array_equal(np.asarray(ref.load(path)["t"].numpy()),
                                  t.numpy())


def test_bfloat16_round_trips_bit_for_bit(tmp_path, monkeypatch):
    """bf16 is written as ml_dtypes' bfloat16 where that is installed (the
    reference reads it as bf16) and as its int16 bits otherwise (as on the
    card); both load back bit for bit."""
    v = torch.randn(5, 7).to(torch.bfloat16)
    for with_ml in (True, False):
        if not with_ml:
            monkeypatch.setattr(port_io, "_numpy_bf16", lambda: None)
        path = str(tmp_path / f"bf16_{with_ml}.pd")
        port.save({"w": v}, path)
        back = port.load(path)["w"]
        assert back.dtype == port.bfloat16
        assert torch.equal(back._value.view(torch.int16), v.view(torch.int16))
        if with_ml:
            r = ref.load(path)["w"]
            assert str(r.dtype) == "bfloat16"
            np.testing.assert_array_equal(np.asarray(r.numpy(), np.float32),
                                          v.float().numpy())


def test_bfloat16_numpy_is_float32():
    """numpy() of a bf16 tensor returns float32 (exact): numpy has no bf16
    without ml_dtypes, which the card's installation lacks."""
    t = port.to_tensor(np.array([1.5, -2.25, 3.0], np.float32)).astype("bfloat16")
    a = t.numpy()
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, [1.5, -2.25, 3.0])


def test_flags():
    assert port.get_flags("FLAGS_check_nan_inf") == {"FLAGS_check_nan_inf": False}
    port.set_flags({"FLAGS_benchmark": True, "FLAGS_custom_thing": 3})
    got = port.get_flags(["FLAGS_benchmark", "FLAGS_custom_thing", "FLAGS_none"])
    assert got == {"FLAGS_benchmark": True, "FLAGS_custom_thing": 3,
                   "FLAGS_none": None}
    port.set_flags({"FLAGS_benchmark": False})
    # the one flag that acts, as in the reference
    before = torch.get_float32_matmul_precision()
    port.set_flags({"FLAGS_matmul_precision": "highest"})
    try:
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_float32_matmul_precision(before)


def test_dtype_conversion():
    conv = dtype_mod.convert_dtype
    assert conv("float32") is torch.float32
    assert conv("fp16") is torch.float16 and conv("bf16") is torch.bfloat16
    assert conv("int") is torch.int32 and conv("long") is torch.int64
    assert conv(np.float64) is torch.float64 and conv(np.dtype("int8")) is torch.int8
    assert conv(torch.complex64) is torch.complex64
    assert conv(port.to_tensor([1.0]).dtype) is torch.float32
    import ml_dtypes

    assert conv(ml_dtypes.bfloat16) is torch.bfloat16
    with pytest.raises(TypeError):
        conv("floaty32")
    d = port.to_tensor([1, 2]).dtype
    assert d == np.int64 and d == "int64" and d == port.int64 and d.name == "int64"
    assert str(port.to_tensor([1.0]).dtype) == "paddle.float32"
    # Paddle's default dtype rule for host data
    assert port.to_tensor(1.5).dtype == port.float32
    assert port.to_tensor(np.array([1.5])).dtype == port.float64
    assert port.to_tensor(3).dtype == port.int64
    assert port.get_default_dtype() == "float32"
    port.set_default_dtype("float64")
    try:
        assert port.to_tensor([1.5]).dtype == port.float64
        assert port.zeros([2]).dtype == port.float64
    finally:
        port.set_default_dtype("float32")
    with pytest.raises(TypeError):
        port.set_default_dtype("int32")


def test_device_defaults():
    assert port.get_device() == "cpu"
    assert port.is_compiled_with_cuda() and not ref.is_compiled_with_cuda()
    t = port.to_tensor([1.0], place=port.CPUPlace())
    assert t.place == port.CPUPlace()
    port.device._default = "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="set_device"):
            port.to_tensor([1.0])
        with pytest.raises(RuntimeError):
            port.set_device("gpu")
    port.set_device("cpu")
    assert port.to_tensor([1.0]).place == port.CPUPlace()
