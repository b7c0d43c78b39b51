"""The port's rpc (`paddle_tpu_torch.distributed.rpc`) against the JAX
package's: tests/test_rpc.py's cases (one worker: sync and async calls,
the worker infos, a remote exception raised again, an unknown worker; a
call before init; two processes; timeouts), and the wire format, the same
length-prefixed pickles both ways: a port client against the JAX package's
request server and the reverse.
"""

import os
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import paddle_tpu_torch.distributed.rpc as rpc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _double(x):
    return 2 * x


def _add(a, b=0):
    return a + b


def _boom():
    raise ValueError("remote failure")


def _slow(seconds):
    import time
    time.sleep(seconds)
    return "done"


class TestSingleWorker:
    def setup_method(self, m):
        rpc.init_rpc("worker0", rank=0, world_size=1,
                     master_endpoint=f"127.0.0.1:{_free_port()}")

    def teardown_method(self, m):
        rpc.shutdown()

    def test_sync_async_and_infos(self):
        assert rpc.rpc_sync("worker0", _double, args=(21,)) == 42
        assert rpc.rpc_sync("worker0", _add, args=(1,), kwargs={"b": 2}) == 3
        fut = rpc.rpc_async("worker0", _double, args=(5,))
        assert fut.wait() == 10
        arr = np.arange(6).reshape(2, 3)
        out = rpc.rpc_sync("worker0", _double, args=(arr,))
        np.testing.assert_array_equal(out, 2 * arr)

        me = rpc.get_current_worker_info()
        assert me.name == "worker0" and me.rank == 0
        assert rpc.get_worker_info("worker0") == me
        assert rpc.get_all_worker_infos() == [me]

    def test_remote_exception_reraises(self):
        with pytest.raises(ValueError, match="remote failure"):
            rpc.rpc_sync("worker0", _boom)

    def test_unknown_worker(self):
        with pytest.raises(ValueError, match="unknown rpc worker"):
            rpc.rpc_sync("nobody", _double, args=(1,))

    def test_init_twice_raises(self):
        with pytest.raises(RuntimeError, match="already called"):
            rpc.init_rpc("again", rank=0, world_size=1,
                         master_endpoint=f"127.0.0.1:{_free_port()}")


def test_requires_init():
    with pytest.raises(RuntimeError, match="not initialized"):
        rpc.rpc_sync("worker0", _double, args=(1,))


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import paddle_tpu_torch.distributed.rpc as rpc

    def mul3(x):
        return 3 * x

    rank = int(sys.argv[1])
    rpc.init_rpc(f"w{{rank}}", rank=rank, world_size=2,
                 master_endpoint=sys.argv[2])
    if rank == 0:
        out = rpc.rpc_sync("w1", mul3, args=(14,))
        assert out == 42, out
        infos = rpc.get_all_worker_infos()
        assert [w.name for w in infos] == ["w0", "w1"], infos
        print("RPC_OK", out)
    rpc.shutdown()
""")


def test_two_processes(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=ROOT))
    ep = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), ep],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
             for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    assert "RPC_OK 42" in outs[0][0], outs


class TestTimeouts:
    def setup_method(self, m):
        rpc.init_rpc("w0", rank=0, world_size=1,
                     master_endpoint=f"127.0.0.1:{_free_port()}")

    def teardown_method(self, m):
        rpc.shutdown()

    def test_call_timeout_raises(self):
        with pytest.raises(Exception) as ei:
            rpc.rpc_sync("w0", _slow, args=(2,), timeout=0.5)
        assert "timed out" in str(ei.value).lower() or isinstance(
            ei.value, (TimeoutError, OSError)), ei.value

    def test_async_timeout_surfaces_in_future(self):
        fut = rpc.rpc_async("w0", _slow, args=(2,), timeout=0.5)
        with pytest.raises(Exception) as ei:
            fut.wait()
        assert "timed out" in str(ei.value).lower() or isinstance(
            ei.value, (TimeoutError, OSError)), ei.value

    def test_fast_call_within_timeout(self):
        assert rpc.rpc_sync("w0", _double, args=(4,), timeout=30) == 8


@pytest.mark.parametrize("server_side", ["reference", "port"])
def test_wire_format_interoperates(server_side):
    """A request framed by one package is served by the other's server, and
    its reply is read by the first package's framing."""
    import paddle_tpu.distributed.rpc as ref_rpc

    server_mod, client_mod = ((ref_rpc, rpc) if server_side == "reference"
                              else (rpc, ref_rpc))
    server = server_mod._RpcServer(host="127.0.0.1")
    try:
        for call, want in (((_double, (21,), {}), ("ok", 42)),
                           ((_add, (1,), {"b": 2}), ("ok", 3))):
            with socket.create_connection((server.host, server.port),
                                          timeout=10) as conn:
                client_mod._send_msg(conn, pickle.dumps(call))
                assert pickle.loads(client_mod._recv_msg(conn)) == want
        with socket.create_connection((server.host, server.port),
                                      timeout=10) as conn:
            client_mod._send_msg(conn, pickle.dumps((_boom, (), {})))
            status, err = pickle.loads(client_mod._recv_msg(conn))
        assert status == "err" and isinstance(err, ValueError)
    finally:
        server.stop()
