"""The port's native rendezvous store (`paddle_tpu_torch.distributed.store`
on `csrc/host/tcp_store.cc`) against the JAX package's
(`paddle_tpu.distributed.store` on `native/tcp_store.cc`):

- the C++ source is the JAX package's, byte for byte below its header;
- a port client against a JAX-package master, and the reverse, through
  every operation (set, get, tryget, add, wait, delete_key, barrier);
- the connect backoff of tests/test_resilience.py:530 and :557 (a late
  bind rescued, a missing master given up on after the deadline);
- the port rule: `create_or_get_global_tcp_store` binds the master port +
  1, and a 2-rank gloo job under the port's launcher calls both
  `init_parallel_env()` (c10d on the master port) and
  `create_or_get_global_tcp_store()` from the launcher's environment.
"""

import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from paddle_tpu_torch.distributed import store as port_store
from paddle_tpu_torch.distributed.store import TCPStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_host_source_is_the_reference_copy():
    port_src = open(os.path.join(ROOT, "paddle_tpu_torch", "csrc", "host",
                                 "tcp_store.cc")).read()
    ref_src = open(os.path.join(ROOT, "native", "tcp_store.cc")).read()
    head, sep, body = port_src.partition("//\n// TCPStore: TCP key-value")
    assert "native/tcp_store.cc" in head
    assert sep + body == "//\n" + ref_src


def _ops(master, client):
    """Every operation through `client` against a server `master` hosts;
    returns what each gave."""
    out = {}
    client.set("k", b"v1")
    out["get"] = master.get("k")
    master.set("s", "text")
    out["get_str"] = client.get("s")
    out["tryget_absent"] = client.tryget("absent")
    out["tryget"] = client.tryget("k")
    big = os.urandom((1 << 20) + 17)   # past the first read buffer
    client.set("big", big)
    out["big"] = master.get("big") == big and client.tryget("big") == big
    out["add"] = [client.add("n", 3), master.add("n", 4), client.add("n", -2)]
    got = {}
    t = threading.Thread(target=lambda: got.setdefault(
        "w", (client.wait("late"), client.get("late"))[1]))
    t.start()
    time.sleep(0.2)
    master.set("late", b"here")
    t.join(5)
    out["wait"] = got.get("w")
    client.delete_key("k")
    out["deleted"] = master.tryget("k")
    done = []
    t = threading.Thread(target=lambda: (client.barrier("b", 2, 1),
                                         done.append(1)))
    t.start()
    master.barrier("b", 2, 0)
    t.join(5)
    out["barrier"] = done == [1]
    return out


WANT = {"get": b"v1", "get_str": b"text", "tryget_absent": None,
        "tryget": b"v1", "big": True, "add": [3, 7, 5], "wait": b"here",
        "deleted": None, "barrier": True}


@pytest.mark.parametrize("master_side", ["reference", "port"])
def test_port_and_reference_interoperate(master_side):
    from paddle_tpu.distributed.store import TCPStore as RefStore

    Master, Client = ((RefStore, TCPStore) if master_side == "reference"
                      else (TCPStore, RefStore))
    master = Master("127.0.0.1", 0, is_master=True, world_size=2)
    client = Client("127.0.0.1", master.port, world_size=2, timeout=10)
    try:
        assert _ops(master, client) == WANT
    finally:
        client.close()
        master.close()


def test_store_connect_backoff_rescues_late_bind():
    """Workers racing the master's bind at pod (re)start: the client retries
    with backoff until the server appears (tests/test_resilience.py:530)."""
    port = _free_port()
    holder = {}

    def bind_late():
        time.sleep(0.7)
        holder["srv"] = TCPStore("127.0.0.1", port, is_master=True)

    t = threading.Thread(target=bind_late, daemon=True)
    t.start()
    client = TCPStore("127.0.0.1", port, is_master=False, timeout=10)
    try:
        client.set("k", b"v")
        assert client.get("k") == b"v"
    finally:
        client.close()
        t.join()
        holder["srv"].close()


def test_store_connect_gives_up_after_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="attempt"):
        TCPStore("127.0.0.1", _free_port(), is_master=False, timeout=0.8)
    assert time.monotonic() - t0 < 10


def test_global_store_takes_the_master_port_plus_one(monkeypatch):
    port = _free_port()
    monkeypatch.setattr(port_store, "_global_store", None)
    monkeypatch.setenv("PADDLE_MASTER", f"127.0.0.1:{port - 1}")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    st = port_store.create_or_get_global_tcp_store()
    try:
        assert st.port == port == port_store.master_endpoint()[1] + 1
        assert port_store.create_or_get_global_tcp_store() is st
    finally:
        st.close()
        port_store._global_store = None


GLOO_JOB = """
import json, os, time
import torch
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import eager_multiproc as em
from paddle_tpu_torch.distributed.store import create_or_get_global_tcp_store
dist.init_parallel_env(device="cpu")
st = create_or_get_global_tcp_store()
r = dist.get_rank()
t = torch.full((3,), r + 1.0)
dist.all_reduce(t)
st.set(f"hello/{r}", str(r * 10))
st.barrier("b0", dist.get_world_size(), r)
peer = int(st.get(f"hello/{1 - r}"))
print("RESULT", json.dumps({
    "rank": r, "world": dist.get_world_size(), "sum": t.tolist(),
    "peer": peer, "store_port": st.port,
    "master": os.environ["PADDLE_MASTER"],
    "local": os.environ["LOCAL_RANK"],
    "em": em.allreduce_value([r, 2 * r]).tolist()}), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def test_c10d_and_native_store_share_the_launchers_master(tmp_path):
    """Two gloo ranks under `python -m paddle_tpu_torch.distributed.launch
    --nproc_per_node 2`: each runs init_parallel_env() and
    create_or_get_global_tcp_store() from the launcher's environment; c10d
    binds the master port, the native store the port + 1, and both carry
    traffic."""
    import json

    script = tmp_path / "job.py"
    script.write_text(GLOO_JOB)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "MASTER_"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--log_dir={tmp_path}/log", "--nproc_per_node=2", str(script)],
        env=env, capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = []
    for r in range(2):
        log = open(tmp_path / "log" / f"workerlog.{r}.r0").read()
        line = [ln for ln in log.splitlines() if ln.startswith("RESULT ")]
        assert line, log[-3000:]
        res.append(json.loads(line[0][7:]))
    assert [x["rank"] for x in res] == [0, 1]
    assert [x["local"] for x in res] == ["0", "1"]
    master = res[0]["master"]
    assert master.startswith("127.0.0.1:") and res[1]["master"] == master
    for x in res:
        assert x["world"] == 2 and x["sum"] == [3.0] * 3
        assert x["store_port"] == int(master.rsplit(":", 1)[1]) + 1
        assert x["em"] == [1, 2]
    assert [x["peer"] for x in res] == [10, 0]
