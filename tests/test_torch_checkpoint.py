"""The port's sharded, crash-safe checkpoint (`paddle_tpu_torch.distributed.
checkpoint`) against the JAX package's:

- the commit protocol, the cases of tests/test_resilience.py::
  TestCommitProtocol (:45-232) through the port's fault points, and a kill
  at each fault point in a fresh interpreter;
- across packages, both ways: gpt3_tiny's parameters and AdamW state saved
  by `paddle_tpu.distributed.checkpoint` load into the port and the
  reverse, in float32 and bfloat16, the bfloat16 case with ml_dtypes and
  again with the port's no-ml_dtypes route forced (which routes the JAX
  package can read is what the bfloat16 test shows: its loader casts what
  it reads, and it cannot read bfloat16 from an npz at all, its own
  checkpoints included; ROADMAP queue C);
- sharded: 2 gloo ranks save a ZeRO-3 step's state (each its own shards,
  never gathered), which restores at mp 2 over the same ranks, at one rank,
  and in the JAX package in one process;
- resume: a gpt3_tiny step saved after step 2 and restored into a fresh
  step gives steps 3-4 equal to the uninterrupted run's, losses and
  parameters bit for bit.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as port
from paddle_tpu_torch.distributed import faults
from paddle_tpu_torch.distributed.checkpoint import (
    COMMIT_FILE,
    CheckpointCorruptError,
    CheckpointManager,
    LocalShard,
    Metadata,
    latest_checkpoint,
    load_state_dict,
    save_state_dict,
    validate_checkpoint,
)
from paddle_tpu_torch.distributed.checkpoint.metadata import metadata_path
from paddle_tpu_torch.distributed.faults import FAULT_EXIT_CODE, FaultInjected

# the module (the package's attribute of that name is the function)
save_mod = importlib.import_module(
    "paddle_tpu_torch.distributed.checkpoint.save_state_dict")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_worker import Ranks, check  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.device._default = "cuda"


@pytest.fixture
def injector(monkeypatch):
    """Arm the port's fault points through PADDLE_FAULT_INJECT (the
    reference's `fault_injector` fixture, on the port's `faults`)."""
    from tools import fault_inject as fi

    class _Injector:
        def arm(self, point, action, nth=None):
            spec = f"{point}:{action}" + (f"@{nth}" if nth else "")
            faults.reset()
            monkeypatch.setenv("PADDLE_FAULT_INJECT", spec)

        def disarm(self):
            monkeypatch.delenv("PADDLE_FAULT_INJECT", raising=False)
            faults.reset()

        corrupt = staticmethod(fi.corrupt_file)
        truncate = staticmethod(fi.truncate_file)

    inj = _Injector()
    yield inj
    inj.disarm()


def _sd(val=0.0, n=6):
    return {"w": torch.full((n,), val, dtype=torch.float32)}


# --------------------------------------------------------------------------- #
# the commit protocol (tests/test_resilience.py::TestCommitProtocol)
# --------------------------------------------------------------------------- #


def test_commit_layout(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_sd(1.0), 7)
    path = mgr.path_for(7)
    assert os.path.isfile(os.path.join(path, COMMIT_FILE))
    assert not os.path.isdir(path + ".tmp")
    assert sorted(os.listdir(path)) == ["0.metadata", "0_0.distcp", COMMIT_FILE]
    meta = Metadata.load(metadata_path(path))
    assert meta.file_checksums
    for entries in meta.state_dict_metadata.values():
        assert all(m.checksum.startswith("crc32:") for m in entries)
    assert validate_checkpoint(path) == (True, "")


def test_interrupted_save_is_skipped_and_swept(tmp_path, injector):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_sd(1.0), 1)
    mgr.save(_sd(2.0), 2)
    injector.arm("ckpt.before_commit", "exc")
    with pytest.raises(FaultInjected):
        mgr.save(_sd(3.0), 3)
    injector.disarm()
    assert os.path.isdir(mgr.path_for(3) + ".tmp")
    assert not os.path.isdir(mgr.path_for(3))
    info = latest_checkpoint(str(tmp_path))
    assert info.step == 2
    tgt = _sd(0.0)
    load_state_dict(tgt, info.path)
    assert float(tgt["w"][0]) == 2.0
    mgr.save(_sd(4.0), 4)
    assert not os.path.isdir(mgr.path_for(3) + ".tmp")
    assert latest_checkpoint(str(tmp_path)).step == 4


def test_mid_save_failure_leaves_no_metadata(tmp_path, injector):
    mgr = CheckpointManager(str(tmp_path))
    injector.arm("ckpt.mid_save", "exc")
    with pytest.raises(FaultInjected):
        mgr.save(_sd(1.0), 1)
    injector.disarm()
    assert not os.path.exists(metadata_path(mgr.path_for(1) + ".tmp"))
    assert latest_checkpoint(str(tmp_path)) is None


def test_checksum_mismatch_names_file(tmp_path, injector):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_sd(1.0), 1)
    mgr.save(_sd(2.0), 2)
    bad = injector.corrupt(mgr.path_for(2))
    with pytest.raises(CheckpointCorruptError) as ei:
        load_state_dict(_sd(0.0), mgr.path_for(2))
    assert os.path.basename(bad) in str(ei.value)
    assert latest_checkpoint(str(tmp_path)).step == 1


def test_truncated_shard_detected(tmp_path, injector):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_sd(5.0), 1)
    injector.truncate(mgr.path_for(1), frac=0.3)
    live = _sd(0.5)
    with pytest.raises(CheckpointCorruptError):
        load_state_dict(live, mgr.path_for(1))
    assert float(live["w"][0]) == 0.5   # verified before anything is written
    assert latest_checkpoint(str(tmp_path)) is None


def test_restore_latest_rolls_back_partial_load(tmp_path, monkeypatch):
    from paddle_tpu_torch.distributed.checkpoint import manager as mgr_mod

    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_sd(7.0), 1)

    def half_load_then_die(state_dict, path, **kw):
        state_dict["w"].mul_(0.0)
        raise CheckpointCorruptError("later shard crc mismatch")

    monkeypatch.setattr(mgr_mod, "load_state_dict", half_load_then_die)
    live = _sd(3.0)
    assert mgr.restore_latest(live) is None
    np.testing.assert_array_equal(live["w"].numpy(), np.full(6, 3.0, np.float32))


def test_restore_latest_rolls_back_on_key_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_sd(7.0), 1)
    live = _sd(3.0)
    live["brand_new_param"] = torch.full((2,), 5.0)
    with pytest.raises(KeyError):
        mgr.restore_latest(live)
    np.testing.assert_array_equal(live["w"].numpy(), np.full(6, 3.0, np.float32))


def test_keep_last_n_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
    for s in range(1, 6):
        mgr.save(_sd(float(s)), s)
    assert sorted(os.listdir(str(tmp_path))) == ["step_4", "step_5"]


def test_async_save_snapshots_at_call_time(tmp_path):
    """The snapshot is a copy taken on the caller's thread: an in-place
    update after save() (as the step makes to parameters and moments) does
    not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    sd = _sd(3.0)
    mgr.save(sd, 1)
    sd["w"].fill_(99.0)
    mgr.wait()
    tgt = _sd(0.0)
    assert mgr.restore_latest(tgt) == 1
    assert float(tgt["w"][0]) == 3.0


def test_async_failure_surfaces_on_wait(tmp_path, injector):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    injector.arm("ckpt.before_commit", "exc")
    mgr.save(_sd(1.0), 1)
    with pytest.raises(FaultInjected):
        mgr.wait()
    injector.disarm()
    assert latest_checkpoint(str(tmp_path)) is None


def test_overwrite_preserves_unrelated_files(tmp_path):
    path = str(tmp_path / "ckpt")
    save_state_dict(_sd(1.0), path)
    keep = os.path.join(path, "notes.txt")
    with open(keep, "w") as f:
        f.write("user data")
    save_state_dict(_sd(2.0), path)
    assert open(keep).read() == "user data"
    assert validate_checkpoint(path) == (True, "")
    tgt = _sd(0.0)
    load_state_dict(tgt, path)
    assert float(tgt["w"][0]) == 2.0


def test_legacy_checkpoint_without_checksums_loads(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_sd(8.0), 1)
    path = mgr.path_for(1)
    meta = Metadata.load(metadata_path(path))
    meta.file_checksums = {}
    for entries in meta.state_dict_metadata.values():
        for m in entries:
            m.checksum = ""
    meta.save(metadata_path(path))
    tgt = _sd(0.0)
    load_state_dict(tgt, path)
    assert float(tgt["w"][0]) == 8.0


@pytest.mark.parametrize("point", ["ckpt.before_shards", "ckpt.mid_save",
                                   "ckpt.before_commit", "ckpt.before_rename"])
def test_kill_at_each_fault_point_keeps_the_last_commit(tmp_path, point):
    """A process killed (os._exit, no cleanup) at a fault point of its
    second save: the first commit is what discovery finds, and a third
    save in a new process commits over the leftovers."""
    root = str(tmp_path / "ck")
    code = f"""
import torch
from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
mgr = CheckpointManager({root!r})
for s in (1, 2):
    mgr.save({{"w": torch.full((6,), float(s))}}, s)
"""
    env = dict(os.environ, PYTHONPATH=ROOT,
               PADDLE_FAULT_INJECT=f"{point}:kill@2")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == FAULT_EXIT_CODE, out.stderr
    info = latest_checkpoint(root)
    assert info.step == 1
    tgt = _sd(0.0)
    load_state_dict(tgt, info.path)
    assert float(tgt["w"][0]) == 1.0
    mgr = CheckpointManager(root)
    mgr.save(_sd(3.0), 3)
    assert latest_checkpoint(root).step == 3
    assert not any(d.endswith(".tmp") for d in os.listdir(root))


# --------------------------------------------------------------------------- #
# gpt3_tiny's training state, across the two packages
# --------------------------------------------------------------------------- #

IDS = np.random.default_rng(0).integers(0, 1024, (2, 16))


def _flatten_optimizer(state):
    """The reference's Optimizer.state_dict() flattened with dots, the
    names `train_state()` gives."""
    out = {"optimizer._step_count": state["_step_count"]}
    for k, v in state.items():
        if k.startswith("param_"):
            for key, t in v.items():
                out[f"optimizer.{k}.{key}"] = t
    return out


def _ref_state():
    """{name: numpy array}: gpt3_tiny after one AdamW step of the JAX
    package's TrainStep, with its optimizer state."""
    import paddle_tpu as ref
    from paddle_tpu.models import GPTForCausalLM, GPTPretrainingCriterion, gpt3_tiny
    from paddle_tpu.optimizer import AdamW

    ref.seed(1)
    m = GPTForCausalLM(gpt3_tiny())
    crit = GPTPretrainingCriterion()
    opt = AdamW(1e-3, parameters=m.parameters())
    step = ref.jit.TrainStep(m, lambda lg, lb: crit(lg, lb), opt)
    step(ref.to_tensor(IDS), ref.to_tensor(IDS))
    step.sync_weights()
    step.sync_optimizer()
    flat = {k: v for k, v in m.state_dict().items()}
    ost = opt.state_dict()
    flat.update(_flatten_optimizer(ost))
    flat["optimizer._step_count"] = np.asarray(ost["_step_count"])
    return {k: np.asarray(v._value if hasattr(v, "_value") else v)
            for k, v in flat.items()}


def _port_step(seed=2, cls=None):
    from paddle_tpu_torch.distributed import DistributedTrainStep
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_tiny)
    from paddle_tpu_torch.optimizer import AdamW

    m = GPTForCausalLM(gpt3_tiny(), seed=seed)
    crit = GPTPretrainingCriterion()
    opt = AdamW(1e-3, parameters=m.parameters())
    return (cls or DistributedTrainStep)(m, lambda lg, lb: crit(lg, lb), opt)


def _host(t):
    return t.detach().cpu().float().numpy() if t.dtype is torch.bfloat16 \
        else t.detach().cpu().numpy()


def _bits(t):
    """A bfloat16 torch tensor's or numpy (ml_dtypes) array's int16 bits."""
    if isinstance(t, torch.Tensor):
        return t.detach().contiguous().view(torch.int16).numpy()
    return np.ascontiguousarray(t).view(np.int16)


def test_train_state_has_the_references_names_and_shapes():
    want = _ref_state()
    step = _port_step()
    st = step.train_state()
    assert sorted(st) == sorted(want)
    for k, v in st.items():
        assert tuple(v.shape) == want[k].shape, k
    step(IDS, IDS)
    assert int(step.train_state()["optimizer._step_count"]) == 1


def test_reference_checkpoint_loads_into_the_port_f32(tmp_path):
    import paddle_tpu as ref
    from paddle_tpu.distributed.checkpoint import \
        save_state_dict as ref_save

    want = _ref_state()
    ref_save({k: ref.to_tensor(v) for k, v in want.items()}, str(tmp_path))
    step = _port_step()
    st = step.train_state()
    load_state_dict(st, str(tmp_path))
    assert step.optimizer._step_count == 1
    for k, v in st.items():
        np.testing.assert_array_equal(_host(v), want[k], err_msg=k)


@pytest.mark.parametrize("ml_dtypes", [True, False], ids=["ml_dtypes", "bits"])
def test_port_checkpoint_loads_into_the_reference_f32(tmp_path, monkeypatch,
                                                      ml_dtypes):
    import paddle_tpu as ref
    from paddle_tpu.distributed.checkpoint import \
        load_state_dict as ref_load

    if not ml_dtypes:   # no bfloat16 here: the route must not matter
        monkeypatch.setattr(save_mod, "_numpy_bf16", lambda: None)
    step = _port_step(seed=4)
    step(IDS, IDS)
    st = step.train_state()
    save_state_dict(st, str(tmp_path))
    tgt = {k: ref.to_tensor(np.zeros(tuple(v.shape), _host(v).dtype))
           for k, v in st.items()}
    ref_load(tgt, str(tmp_path))
    for k, v in st.items():
        np.testing.assert_array_equal(np.asarray(tgt[k]._value), _host(v),
                                      err_msg=k)


def test_reference_bf16_checkpoint_loads_into_the_port_bit_for_bit(tmp_path):
    """The JAX package writes bfloat16 as ml_dtypes arrays, which np.load
    returns as 2-byte voids; the port reads their bits."""
    import paddle_tpu as ref
    from paddle_tpu.distributed.checkpoint import \
        save_state_dict as ref_save

    want = _ref_state()
    ref_save({k: ref.to_tensor(v).astype("bfloat16") if v.dtype.kind == "f"
              else ref.to_tensor(v) for k, v in want.items()}, str(tmp_path))
    meta = Metadata.load(metadata_path(str(tmp_path)))
    assert {m.dtype for v in meta.state_dict_metadata.values()
            for m in v} == {"bfloat16", "int32"}
    tgt = {k: torch.zeros(v.shape, dtype=torch.bfloat16 if v.dtype.kind == "f"
                          else torch.int64) for k, v in want.items()}
    load_state_dict(tgt, str(tmp_path))
    for k, v in want.items():
        if v.dtype.kind == "f":
            import ml_dtypes

            np.testing.assert_array_equal(
                _bits(tgt[k]), _bits(v.astype(ml_dtypes.bfloat16)), err_msg=k)
        else:
            assert int(tgt[k]) == int(v)


@pytest.mark.parametrize("ml_dtypes", [True, False], ids=["ml_dtypes", "bits"])
def test_port_bf16_checkpoint_routes(tmp_path, monkeypatch, ml_dtypes):
    """The port's bfloat16 checkpoint, through each route: the port reads
    its own bit for bit; the JAX package fails on the ml_dtypes route as it
    fails on a bfloat16 checkpoint of its own (np.load gives it 2-byte
    voids, which it cannot cast), and on the bits route it reads int16
    numbers where bfloat16 values were (its loader casts what it reads:
    `paddle_tpu/distributed/checkpoint/load_state_dict.py:96-127`, :174-177).
    ROADMAP queue C records both."""
    import ml_dtypes as mld

    import paddle_tpu as ref
    from paddle_tpu.distributed.checkpoint import \
        load_state_dict as ref_load
    from paddle_tpu.distributed.checkpoint import \
        save_state_dict as ref_save

    if not ml_dtypes:
        monkeypatch.setattr(save_mod, "_numpy_bf16", lambda: None)
    step = _port_step(seed=5)
    step(IDS, IDS)
    st = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
          for k, v in step.train_state().items()}
    save_state_dict(st, str(tmp_path / "port"))
    back = {k: torch.zeros_like(v) for k, v in st.items()}
    load_state_dict(back, str(tmp_path / "port"))
    for k, v in st.items():
        assert torch.equal(back[k].view(torch.int16) if v.is_floating_point()
                           else back[k], v.view(torch.int16)
                           if v.is_floating_point() else v), k

    name = "gpt.embed_tokens.weight"
    want = st[name]

    def ref_target():
        return {name: ref.to_tensor(np.zeros(tuple(want.shape),
                                             np.float32)).astype("bfloat16")}

    if ml_dtypes:
        with pytest.raises(ValueError, match="No cast function"):
            ref_load(ref_target(), str(tmp_path / "port"))
        # the same failure on the JAX package's own bfloat16 checkpoint
        ref_save(ref_target(), str(tmp_path / "ref"))
        with pytest.raises(ValueError, match="No cast function"):
            ref_load(ref_target(), str(tmp_path / "ref"))
    else:
        tgt = ref_target()
        ref_load(tgt, str(tmp_path / "port"))
        got = np.asarray(tgt[name]._value)
        bits = _bits(want)
        np.testing.assert_array_equal(got, bits.astype(np.float32).astype(
            mld.bfloat16))
        assert not np.array_equal(_bits(got), bits)


# --------------------------------------------------------------------------- #
# resume
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["DistributedTrainStep", "TrainStep"])
def test_resumed_step_equals_the_uninterrupted_one_bit_for_bit(tmp_path, kind):
    """gpt3_tiny in f32, AdamW: saved (async) after step 2, restored into a
    fresh step whose model starts elsewhere; its steps 3-4 give the
    uninterrupted run's losses and parameters bit for bit."""
    from paddle_tpu_torch.jit import TrainStep

    cls = TrainStep if kind == "TrainStep" else None
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, 1024, (2, 16)) for _ in range(4)]
    step = _port_step(seed=6, cls=cls)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    losses = []
    for i, ids in enumerate(batches):
        losses.append(step(ids, ids).item())
        if i == 1:
            mgr.save(step.train_state(), 2)
    mgr.wait()
    fresh = _port_step(seed=9, cls=cls)
    assert mgr.restore_latest(fresh.train_state()) == 2
    assert fresh.optimizer._step_count == 2
    resumed = [fresh(ids, ids).item() for ids in batches[2:]]
    assert resumed == losses[2:]
    for (k, a), b in zip(step.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    for k, v in step.train_state().items():
        assert torch.equal(v, fresh.train_state()[k]), k


# --------------------------------------------------------------------------- #
# sharded: 2 gloo ranks at ZeRO-3, restored at mp 2, at one rank, by JAX
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(3)
    ids = [rng.integers(0, 1024, (2, 16)) for _ in range(4)]
    tmp = tmp_path_factory.mktemp("ckpt_ranks")
    res = Ranks("checkpoint", 2, tmp, {"ids": ids}).results(timeout=300)
    return dict(res=res, root=str(tmp / "ck"), ids=ids)


def test_zero3_ranks_each_write_their_own_shards(ranks):
    saved = [check(r) for r in ranks["res"]["zero3_save"]]
    assert saved[0]["files"] == ["0_0.distcp", "1_0.distcp"]
    shards = saved[0]["shards"]
    w = "gpt.embed_tokens.weight"
    # the table's vocab dim is its mp dim, so ZeRO cuts the hidden dim: by
    # rank, [1024, 32] at columns 0 and 32 of the [1024, 64] table
    assert shards[w] == [(0, 0), (0, 32)]
    assert shards["optimizer._step_count"] == [()]
    # never gathered: each rank held its half only
    assert saved[0]["local"][w] == saved[1]["local"][w] == (1024, 32)


def test_restored_at_mp2_equals_the_saved_state(ranks):
    saved = check(ranks["res"]["zero3_save"][0])
    for r in ranks["res"]["mp_restore"]:
        got = check(r)
        assert got["step"] == 2
        assert sorted(got["state"]) == sorted(saved["state"])
        for k, v in saved["state"].items():
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)
        # steps 3-4 at mp 2 continue the ZeRO-3 run; mp splits the products,
        # so the sums differ in rounding: rtol 1e-5
        np.testing.assert_allclose(got["losses"], saved["losses"], rtol=1e-5)


def test_restored_at_one_rank_equals_the_saved_state(ranks):
    saved = check(ranks["res"]["zero3_save"][0])
    step = _port_step(seed=12)
    mgr = CheckpointManager(ranks["root"])
    assert mgr.restore_latest(step.train_state()) == 2
    for k, v in step.train_state().items():
        np.testing.assert_array_equal(_host(v), saved["state"][k], err_msg=k)
    losses = [step(ids, ids).item() for ids in ranks["ids"][2:]]
    np.testing.assert_allclose(losses, saved["losses"], rtol=1e-5)


def test_jax_package_loads_the_zero3_checkpoint(ranks):
    import paddle_tpu as ref
    from paddle_tpu.distributed.checkpoint import latest_checkpoint as ref_latest
    from paddle_tpu.distributed.checkpoint import \
        load_state_dict as ref_load

    saved = check(ranks["res"]["zero3_save"][0])["state"]
    info = ref_latest(ranks["root"])
    assert info.step == 2
    tgt = {k: ref.to_tensor(np.zeros(v.shape, v.dtype)) for k, v in saved.items()}
    ref_load(tgt, info.path)
    for k, v in saved.items():
        np.testing.assert_array_equal(np.asarray(tgt[k]._value), v, err_msg=k)
    meta = json.load(open(os.path.join(info.path, "0.metadata")))
    assert set(meta["file_checksums"]) == {"0_0.distcp", "1_0.distcp"}


def test_pipelined_vpp_stage_rows_restore_at_one_stage(ranks):
    """pp 2 with VPP: each rank writes its two chunks of every stack (rows
    0, 2 and 1, 3 of 4 layers); one process holding every layer restores
    the whole stacks and their moments bit for bit."""
    import dataclasses

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForCausalLMPipe,
                                         GPTPretrainingCriterion, gpt3_tiny)
    from paddle_tpu_torch.optimizer import AdamW

    saved = check(ranks["res"]["vpp_save"][0])
    stack = "stack__self_attn__q_proj__weight"
    assert saved["shards"][stack] == [(0, 0, 0), (1, 0, 0), (2, 0, 0),
                                      (3, 0, 0)]
    cfg = dataclasses.replace(gpt3_tiny(), num_layers=4)
    model = GPTForCausalLMPipe(cfg, num_microbatches=2, pp_schedule="vpp",
                               vpp_degree=2, device="cpu", seed=8)
    crit = GPTPretrainingCriterion()
    step = TrainStep(model, lambda lg, lb: crit(lg, lb),
                     AdamW(learning_rate=1e-3, parameters=model.parameters()))
    mgr = CheckpointManager(os.path.join(os.path.dirname(ranks["root"]),
                                         "ck_vpp"))
    assert mgr.restore_latest(step.train_state()) == 2
    got = step.train_state()
    assert sorted(got) == sorted(saved["state"])
    for k, v in saved["state"].items():
        np.testing.assert_array_equal(_host(got[k]), v, err_msg=k)


def test_local_shards_place_a_region(tmp_path):
    """A LocalShard list: two halves written as shards of one global
    tensor, read back whole and as other cuts."""
    full = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    sd = {"t": [LocalShard(full[:, :3].clone(), (0, 0), (4, 6)),
                LocalShard(full[:, 3:].clone(), (0, 3), (4, 6)),
                LocalShard(full[:, 3:].clone(), (0, 3), (4, 6), write=False)]}
    save_state_dict(sd, str(tmp_path))
    whole = {"t": torch.zeros(4, 6)}
    load_state_dict(whole, str(tmp_path))
    assert torch.equal(whole["t"], full)
    rows = torch.zeros(2, 6)
    load_state_dict({"t": LocalShard(rows, (2, 0), (4, 6))}, str(tmp_path))
    assert torch.equal(rows, full[2:])
