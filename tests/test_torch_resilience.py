"""The port's resilient runtime (`paddle_tpu_torch.distributed.resilience`
under `python -m paddle_tpu_torch.distributed.launch`) against the JAX
package's:

- tests/test_resilience.py's `TestResilientTrainer` (:332), the
  kill-during-save launcher test (:444), the watchdog post-mortem fold
  (:466) and the hang recovery (:483, marked slow as the reference marks
  it); tests/test_observability.py:444 `test_dump_on_injected_crash`;
- across packages, in f32 and bit for bit: a port ResilientTrainer resumes
  from a checkpoint the JAX package's ResilientTrainer committed, and the
  reverse;
- the slice as a whole: gpt3_tiny, its weights carried across by
  `convert.load_paddle_tpu_state`, trained under the port's launcher by a
  ResilientTrainer whose first life is killed while committing its second
  checkpoint; the resumed run's losses and final parameters against the
  JAX package's uninterrupted ResilientTrainer run on the same weights and
  tokens.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as port
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.distributed import comm_watchdog, faults
from paddle_tpu_torch.distributed.checkpoint import latest_checkpoint
from paddle_tpu_torch.distributed.faults import FAULT_EXIT_CODE, FaultInjected
from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
from paddle_tpu_torch.distributed.resilience import (REFORM_EXIT_CODE,
                                                     ResilientTrainer,
                                                     run_with_recovery)
from paddle_tpu_torch.observability import flight, metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
STEPS = 6


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.device._default = "cuda"


@pytest.fixture
def injector(monkeypatch):
    """Arm the port's fault points through PADDLE_FAULT_INJECT."""

    class _Injector:
        def arm(self, point, action, nth=None):
            faults.reset()
            monkeypatch.setenv("PADDLE_FAULT_INJECT", f"{point}:{action}"
                               + (f"@{nth}" if nth else ""))

        def disarm(self):
            monkeypatch.delenv("PADDLE_FAULT_INJECT", raising=False)
            faults.reset()

    yield _Injector()
    monkeypatch.delenv("PADDLE_FAULT_INJECT", raising=False)
    faults.reset()


def _sd(val=0.0, n=6):
    return {"w": torch.full((n,), val)}


class _FakeStore:
    def __init__(self):
        self.d = {}

    def set(self, k, v):
        self.d[k] = v if isinstance(v, bytes) else str(v).encode()

    def tryget(self, k):
        return self.d.get(k)

    def add(self, k, amount):
        cur = int(self.d.get(k, b"0")) + int(amount)
        self.d[k] = str(cur).encode()
        return cur

    def delete_key(self, k):
        self.d.pop(k, None)


# --------------------------------------------------------------------------- #
# the trainer in process (tests/test_resilience.py:332-412)
# --------------------------------------------------------------------------- #


class TestResilientTrainer:
    def test_resume_in_process(self, tmp_path, monkeypatch):
        ckpt = str(tmp_path / "ck")
        w = torch.zeros(4)

        def step_fn(i):
            w.add_(1.0)
            return float(w[0])

        out = ResilientTrainer(step_fn, {"w": w}, ckpt, save_every=2,
                               async_save=False).run(5)
        assert out["resumed_from"] is None and out["last_loss"] == 5.0

        # a restart: fresh tensors, the same checkpoint directory
        monkeypatch.setenv("PADDLE_RESTART_COUNT", "1")
        w2 = torch.zeros(4)
        ran = []

        def step_fn2(i):
            ran.append(i)
            w2.add_(1.0)
            return float(w2[0])

        out2 = ResilientTrainer(step_fn2, {"w": w2}, ckpt, save_every=2,
                                async_save=False).run(8)
        assert out2["resumed_from"] == 4  # the final save of run 1
        assert out2["restart_count"] == 1
        assert ran == [5, 6, 7]
        assert float(w2[0]) == 8.0

    def test_hold_times_out(self, tmp_path):
        m = ElasticManager(store=_FakeStore(), job_id="jh", np_range="2:2",
                           rank=0, timeout=5.0)
        t = ResilientTrainer(lambda i: 0.0, _sd(), str(tmp_path), elastic=m,
                             hold_poll=0.05, hold_timeout=0.3,
                             async_save=False)
        with pytest.raises(RuntimeError, match="hold timed out"):
            t.run(1)

    def test_watchdog_stall_spills_report(self, tmp_path):
        """A region stalled past its comm_task deadline lands in the spill
        file (the post-mortem the launcher folds in on a worker's death)."""
        report_file = str(tmp_path / "wd.report")
        comm_watchdog.disable()
        assert comm_watchdog.enable(timeout_seconds=5.0,
                                    report_file=report_file)
        try:
            with comm_watchdog.comm_task("stalled_step/3", 0.15):
                time.sleep(0.5)
            assert comm_watchdog.timeout_count() >= 1
            deadline = time.time() + 3
            content = ""
            while time.time() < deadline and "stalled_step/3" not in content:
                if os.path.exists(report_file):
                    content = open(report_file).read()
                time.sleep(0.05)
            assert "stalled_step/3" in content
            assert "exceeded" in content
        finally:
            comm_watchdog.disable()


def test_callable_state_heartbeat_and_metrics(tmp_path):
    """`state_dict` as a callable (a step's train_state) is evaluated at each
    save and restore; an elastic manager over the native store beats every
    step, the trainer's families land in the registry, and the reform exit
    code is the reference's."""
    from paddle_tpu_torch.distributed.store import TCPStore

    reg = metrics.reset_default_registry()
    srv = TCPStore("127.0.0.1", 0, is_master=True)
    try:
        w = torch.zeros(3)
        calls = []

        def state():
            calls.append(1)
            return {"w": w}

        m = ElasticManager(store=srv, job_id="cb", np_range="1", rank=0,
                           heartbeat_interval=1.0)
        out = run_with_recovery(lambda i: float(w.add_(1.0)[0]), state,
                                str(tmp_path), 4, save_every=2,
                                async_save=False, elastic=m)
        assert out["last_loss"] == 4.0 and len(calls) == 3  # resume, 2 saves
        assert srv.tryget("cb/completed") == b"1"
        assert reg.get("trainer_step_seconds").count() == 4
        assert reg.get("trainer_checkpoint_save_seconds").count() == 2
        # sampled after each step: under twice the interval
        assert 0 <= reg.get("trainer_heartbeat_age_seconds").value() < 2.0
        assert REFORM_EXIT_CODE == 75
    finally:
        srv.close()
        metrics.reset_default_registry()


@pytest.mark.parametrize("option", ["plan_path", "planner_cfg", "on_plan",
                                    "plan_devices"])
def test_planner_options_raise_naming_the_item(tmp_path, option):
    with pytest.raises(NotImplementedError, match="item 7b-ii"):
        ResilientTrainer(lambda i: 0.0, _sd(), str(tmp_path),
                         **{option: 1})


def test_dump_on_injected_crash(tmp_path, monkeypatch, injector):
    """tests/test_observability.py:444: ResilientTrainer and an armed fault
    point: the flight recorder's post-mortem lands on disk with the dying
    step."""
    metrics.reset_default_registry()
    flight.reset_recorder()
    fl_path = str(tmp_path / "worker.flight")
    monkeypatch.setenv("PADDLE_FLIGHT_FILE", fl_path)
    tl = obs.enable_step_timeline()
    w = torch.zeros(4)

    def step_fn(i):
        w.add_(1.0)
        return float(w[0])

    injector.arm("trainer.before_step", "exc", nth=3)
    try:
        with pytest.raises(FaultInjected):
            ResilientTrainer(step_fn, {"w": w}, str(tmp_path / "ck"),
                             save_every=2, async_save=False).run(6)
    finally:
        injector.disarm()
        tl.uninstall()
        flight.uninstall_crash_handlers()
        flight.reset_recorder()
    doc = json.loads(open(fl_path).read().splitlines()[-1])
    assert "trainer crash at step 2" in doc["reason"]
    steps = [s["step"] for s in doc["steps"]]
    assert steps[-1] == 2  # the aborted step made it into the ring
    assert doc["steps"][-1].get("aborted") is True
    kinds = [e["kind"] for e in doc["events"]]
    assert "trainer_start" in kinds and "checkpoint_save" in kinds
    assert any(k.startswith("trainer_step_seconds")
               for k in doc["metric_deltas"])
    metrics.reset_default_registry()


# --------------------------------------------------------------------------- #
# across packages, f32, bit for bit
# --------------------------------------------------------------------------- #


def _update(w, i):
    """One step of the cross-package trainers, the same f32 numpy
    arithmetic on both sides."""
    return (w * np.float32(0.75) + np.float32(i + 1)).astype(np.float32)


def _uninterrupted():
    w = np.arange(12, dtype=np.float32).reshape(4, 3) / 7
    for i in range(STEPS):
        w = _update(w, i)
    return w


def _ref_life(root, steps):
    import paddle_tpu as ref
    from paddle_tpu.distributed.resilience import ResilientTrainer as RefTrainer

    w = ref.to_tensor(np.arange(12, dtype=np.float32).reshape(4, 3) / 7)

    def step_fn(i):
        w.set_value(ref.to_tensor(_update(np.asarray(w.numpy()), i)))
        return float(np.asarray(w.numpy())[0, 0])

    out = RefTrainer(step_fn, {"w": w}, root, save_every=2,
                     async_save=False).run(steps)
    return out, np.asarray(w.numpy())


def _port_life(root, steps):
    w = torch.from_numpy(np.arange(12, dtype=np.float32).reshape(4, 3) / 7)

    def step_fn(i):
        w.copy_(torch.from_numpy(_update(w.numpy(), i)))
        return float(w[0, 0])

    out = ResilientTrainer(step_fn, {"w": w}, root, save_every=2,
                           async_save=False).run(steps)
    return out, w.numpy().copy()


@pytest.mark.parametrize("first,second", [("reference", "port"),
                                          ("port", "reference")])
def test_resume_across_packages(tmp_path, first, second):
    """The first package's trainer commits steps 1 and 3 and stops; the
    other's resumes from step 3 and finishes; the state equals an
    uninterrupted run's bit for bit."""
    lives = {"reference": _ref_life, "port": _port_life}
    root = str(tmp_path / "ck")
    out, _ = lives[first](root, 4)
    assert out["resumed_from"] is None
    out, w = lives[second](root, STEPS)
    assert out["resumed_from"] == 3 and out["start_step"] == 4
    np.testing.assert_array_equal(w, _uninterrupted())
    assert latest_checkpoint(root).step == STEPS - 1


# --------------------------------------------------------------------------- #
# under the launcher (tests/test_resilience.py:418-527)
# --------------------------------------------------------------------------- #


def _run_launch(tmp_path, extra_args, script_body, extra_env=None,
                timeout=240):
    script = os.path.join(str(tmp_path), "train.py")
    with open(script, "w") as f:
        f.write(script_body)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "MASTER_"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               CKPT_DIR=os.path.join(str(tmp_path), "ckpts"))
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--log_dir={tmp_path}/log", *extra_args, script],
        env=env, capture_output=True, text=True, timeout=timeout,
        cwd=str(tmp_path))


def _life_log(tmp_path, life):
    logs = os.listdir(os.path.join(str(tmp_path), "log"))
    name = [l for l in logs if l.endswith(f".r{life}")][0]
    return open(os.path.join(str(tmp_path), "log", name)).read()


RESILIENT_TRAIN = """
import os
restart = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
if restart == 0:
    # the first life only: die at the second checkpoint, after its
    # metadata is written and before its COMMIT marker
    os.environ["PADDLE_FAULT_INJECT"] = "ckpt.before_commit:kill@2"
import torch
from paddle_tpu_torch.distributed.resilience import ResilientTrainer

w = torch.zeros(4)
def step_fn(i):
    w.add_(1.0)
    return float(w[0])
t = ResilientTrainer(step_fn, {"w": w}, os.environ["CKPT_DIR"], save_every=2,
                     async_save=False)
out = t.run(6)
print("RESUMED_FROM", out["resumed_from"], flush=True)
print("FINAL", float(w[0]), flush=True)
"""


def test_kill_during_save_resumes_from_last_commit(tmp_path):
    """A worker killed mid-save (metadata written, COMMIT absent): the
    launcher respawns it and training resumes from the last committed
    step, the torn save swept by the resumed run's own rotation."""
    proc = _run_launch(tmp_path, ["--max_restart=2"], RESILIENT_TRAIN)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"pod failed (exit {FAULT_EXIT_CODE})" in proc.stderr
    out = _life_log(tmp_path, 1)
    # life 1 committed step 1 (w = 2) and died committing step 3; life 2
    # resumed from step 1 and trained steps 2-5: w = 6
    assert "RESUMED_FROM 1" in out, out
    assert "FINAL 6.0" in out, out
    ckpts = sorted(os.listdir(os.path.join(str(tmp_path), "ckpts")))
    assert all(not d.endswith(".tmp") for d in ckpts), ckpts
    info = latest_checkpoint(os.path.join(str(tmp_path), "ckpts"))
    assert info is not None and info.step == 5


def test_launcher_dumps_watchdog_report(tmp_path):
    """On a worker's death the launcher folds the comm-watchdog spill file
    into the worker log and its own stderr."""
    proc = _run_launch(tmp_path, [], """
import os, sys
with open(os.environ["PADDLE_WD_REPORT_FILE"], "w") as f:
    f.write("[watchdog] task 1 'train_step/7' exceeded 500ms (9000ms elapsed)\\n")
sys.exit(3)
""")
    assert proc.returncode == 3
    assert "comm-watchdog post-mortem for worker 0" in proc.stderr
    assert "train_step/7" in proc.stderr
    log0 = open(os.path.join(str(tmp_path), "log", "workerlog.0.r0")).read()
    assert "comm-watchdog post-mortem" in log0


@pytest.mark.slow
def test_hang_recovery_end_to_end(tmp_path):
    """A step wedges past the watchdog's deadline, the spill thread's
    FatalError line trips the launcher's LogWatcher, the pod is torn down
    and respawned, and training resumes from the last commit."""
    proc = _run_launch(tmp_path, ["--max_restart=2"], """
import os
restart = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
if restart == 0:
    # the 4th step (index 3, after the step-1 commit) hangs for 120 s
    os.environ["PADDLE_FAULT_INJECT"] = "trainer.before_step:sleep:120@4"
import torch
from paddle_tpu_torch.distributed.resilience import ResilientTrainer

w = torch.zeros(4)
def step_fn(i):
    w.add_(1.0)
    return float(w[0])
t = ResilientTrainer(step_fn, {"w": w}, os.environ["CKPT_DIR"], save_every=2,
                     async_save=False, step_timeout=1.0)
out = t.run(6)
print("RESUMED_FROM", out["resumed_from"], flush=True)
print("FINAL", float(w[0]), flush=True)
""", timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "comm-watchdog post-mortem" in proc.stderr
    out = _life_log(tmp_path, 1)
    assert "RESUMED_FROM 1" in out, out
    assert "FINAL 6.0" in out, out


# --------------------------------------------------------------------------- #
# the slice: gpt3_tiny killed mid-commit under the launcher, against the
# JAX package's uninterrupted ResilientTrainer
# --------------------------------------------------------------------------- #

SLICE_WORKER = """
import json, os
restart = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
if restart == 0:
    os.environ["PADDLE_FAULT_INJECT"] = "ckpt.before_commit:kill@2"
import numpy as np
import torch
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed.resilience import ResilientTrainer
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt3_tiny)
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)
d = os.environ["DATA_DIR"]
data = np.load(os.path.join(d, "batches.npz"))
m = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=1)
load_paddle_tpu_state(m, dict(np.load(os.path.join(d, "init.npz"))))
crit = GPTPretrainingCriterion()
step = TrainStep(m, lambda lg, lb: crit(lg, lb),
                 AdamW(learning_rate=float(os.environ["LR"]),
                       parameters=m.parameters()))

def step_fn(i):
    loss = step(data["ids"][i], data["labels"][i]).item()
    print("LOSS", json.dumps([i, loss]), flush=True)
    return loss

out = ResilientTrainer(step_fn, step.train_state, os.environ["CKPT_DIR"],
                       save_every=2, keep_last_n=2, async_save=False).run(6)
print("RESUMED_FROM", out["resumed_from"], flush=True)
np.savez(os.path.join(d, "final.npz"),
         **{k: v.detach().numpy() for k, v in m.state_dict().items()})
"""


def _losses(log):
    return dict(json.loads(ln[5:]) for ln in log.splitlines()
                if ln.startswith("LOSS "))


def test_gpt3_tiny_killed_mid_commit_matches_the_uninterrupted_reference(
        tmp_path, pallas_interpret_unless_hw):
    import paddle_tpu as ref
    from paddle_tpu.distributed.resilience import ResilientTrainer as RefTrainer
    from paddle_tpu.jit import TrainStep as RefStep
    from paddle_tpu.models import GPTForCausalLM as RefGPT
    from paddle_tpu.models import GPTPretrainingCriterion as RefCriterion
    from paddle_tpu.models import gpt3_tiny as ref_tiny
    from paddle_tpu.optimizer import AdamW as RefAdamW

    rng = np.random.default_rng(11)
    ids = rng.integers(0, 1024, (STEPS, 2, 16)).astype(np.int64)
    labels = rng.integers(0, 1024, (STEPS, 2, 16)).astype(np.int64)
    ref.seed(0)
    jm = RefGPT(ref_tiny())
    init = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    data = tmp_path / "data"
    data.mkdir()
    np.savez(data / "init.npz", **init)
    np.savez(data / "batches.npz", ids=ids, labels=labels)

    proc = _run_launch(tmp_path, ["--max_restart=2"], SLICE_WORKER,
                       extra_env={"DATA_DIR": str(data), "LR": str(LR)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"pod failed (exit {FAULT_EXIT_CODE})" in proc.stderr
    first, second = _life_log(tmp_path, 0), _life_log(tmp_path, 1)
    assert "RESUMED_FROM 1" in second, second[-3000:]
    lost = _losses(first)
    resumed = _losses(second)
    assert sorted(lost) == [0, 1, 2, 3] and sorted(resumed) == [2, 3, 4, 5]
    assert latest_checkpoint(str(tmp_path / "ckpts")).step == STEPS - 1

    crit = RefCriterion()
    step = RefStep(jm, lambda lg, lb: crit(lg, lb),
                   RefAdamW(learning_rate=LR, parameters=jm.parameters()))
    ref_losses = []

    def ref_step_fn(i):
        ref_losses.append(float(step(ref.to_tensor(ids[i]),
                                     ref.to_tensor(labels[i]))))
        return ref_losses[-1]

    out = RefTrainer(ref_step_fn, jm.state_dict(), str(tmp_path / "ref_ck"),
                     save_every=2, keep_last_n=2, async_save=False).run(STEPS)
    assert out["resumed_from"] is None
    step.sync_weights()
    np.testing.assert_allclose([lost[i] for i in range(2)]
                               + [resumed[i] for i in range(2, STEPS)],
                               ref_losses, rtol=1e-5)
    # the steps the first life took past its last commit are the resumed
    # run's too
    assert [lost[i] for i in (2, 3)] == [resumed[i] for i in (2, 3)]
    final = np.load(data / "final.npz")
    want = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert sorted(final.files) == sorted(want)
    for k, v in want.items():
        if "self_attn.k_proj.bias" in k:
            # an analytically zero gradient: both packages move it by
            # rounding noise, which Adam scales up to lr a step
            assert np.abs(final[k] - v).max() <= LR * STEPS, k
        else:
            np.testing.assert_allclose(final[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
