"""paddle.distributed.rpc: remote procedure calls between workers
(↔ paddle_tpu/distributed/rpc/__init__.py, the same code and wire format
but for `shutdown`'s last ack, see there;
reference: python/paddle/distributed/rpc/rpc.py, a brpc agent with
PythonFunc serialization and a TCPStore rendezvous). The same API over a
plain TCP request/response server per worker: the brpc agent exists to
co-schedule with the parameter-server runtime, which is out of scope here,
and a thread-pooled socket server carries the same semantics:

- init_rpc(name, rank, world_size, master_endpoint): rendezvous through
  the port's native TCPStore (`distributed.store`; rank 0 hosts it at
  master_endpoint), register this worker's (name, rank, ip, port),
  exchange every worker's info, barrier.
- rpc_sync / rpc_async(to, fn, args, kwargs, timeout): pickle
  (fn, args, kwargs), send them to the target worker over a fresh TCP
  connection as a length-prefixed frame (an 8-byte little-endian length,
  then the pickle), run them there on a worker thread, return the pickled
  result (an exception raises again at the caller, as in the reference).
- shutdown(): barrier (so no call in flight is dropped), then stop the
  server.

As in the reference, callables must be picklable (importable module-level
functions), and the transport trusts the cluster: use it only on networks
the job controls.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import traceback
from collections import namedtuple
from concurrent.futures import Future, ThreadPoolExecutor

__all__ = [
    "init_rpc", "rpc_sync", "rpc_async", "shutdown", "get_worker_info",
    "get_all_worker_infos", "get_current_worker_info", "WorkerInfo",
]

WorkerInfo = namedtuple("WorkerInfo", ["name", "rank", "ip", "port"])

_MAX_RPC_TIMEOUT_S = 500000

_state = {
    "store": None,
    "server": None,
    "pool": None,
    "self": None,          # WorkerInfo
    "workers": {},         # name -> WorkerInfo
    "barrier_round": 0,
}


def _recv_exact(conn, n):
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("rpc: peer closed connection")
        buf += chunk
    return buf


def _send_msg(conn, payload: bytes):
    conn.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv_msg(conn) -> bytes:
    (n,) = struct.unpack("<Q", _recv_exact(conn, 8))
    return _recv_exact(conn, n)


class _RpcServer:
    """Thread-pooled request/response server: one pickled
    (fn, args, kwargs) in, one pickled ("ok"|"err", payload) out.

    `host` should be the rendezvous-routed interface (init_rpc passes it);
    a wildcard bind would expose the unauthenticated pickle endpoint on
    every interface of the host."""

    def __init__(self, host="127.0.0.1", n_threads=8):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind((host, 0))
        except OSError:
            # interface detection can misfire (containers with asymmetric
            # routing): fall back to loopback rather than 0.0.0.0 — a
            # reachable-but-narrow bind beats an open one; cross-host
            # setups pin PADDLE_WORKER_IP explicitly
            self._sock.bind(("127.0.0.1", 0))
            host = "127.0.0.1"
        self.host = host
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._pool = ThreadPoolExecutor(max_workers=n_threads,
                                        thread_name_prefix="rpc-worker")
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True, name="rpc-accept")
        self._accept_thread.start()

    def _accept_loop(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self._pool.submit(self._serve_one, conn)

    def _serve_one(self, conn):
        try:
            with conn:
                # a peer that connects but never sends (crash, port scan)
                # must not pin this worker thread forever and hang stop()
                conn.settimeout(120)
                fn, args, kwargs = pickle.loads(_recv_msg(conn))
                # the RESPONSE send gets a far looser bound: settimeout is
                # total-duration, and a large result over a slow link is
                # legitimate — 120s there would abort it
                conn.settimeout(900)
                try:
                    out = ("ok", fn(*args, **kwargs))
                except BaseException as e:  # noqa: BLE001 — ship to caller
                    out = ("err", e)
                try:
                    payload = pickle.dumps(out)
                except Exception:
                    # unpicklable result/exception: the caller must still
                    # see WHAT happened, not an opaque connection error
                    payload = pickle.dumps(
                        ("err", RuntimeError(
                            "rpc: remote result/exception not picklable:\n"
                            + traceback.format_exc())))
                _send_msg(conn, payload)
        except Exception:  # a connection-level failure: the caller
            pass           # sees its own error

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._pool.shutdown(wait=True)


def _self_ip(master_addr):
    """The address peers can reach this worker at: the local interface that
    routes to the master (PADDLE_WORKER_IP overrides). A 127.0.0.1 default
    would register loopback and break cross-host calls."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect((master_addr, 1))  # UDP: no packets sent
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


def init_rpc(name, rank=None, world_size=None, master_endpoint=None):
    """Reference: rpc.py:85 — TCPStore rendezvous + worker-info exchange +
    start-up barrier."""
    from ..store import TCPStore

    if _state["server"] is not None:
        raise RuntimeError("init_rpc already called; call shutdown() first")
    rank = int(os.environ["PADDLE_TRAINER_ID"]) if rank is None else rank
    world_size = (int(os.environ["PADDLE_TRAINERS_NUM"])
                  if world_size is None else world_size)
    master_endpoint = (master_endpoint if master_endpoint is not None
                       else os.environ["PADDLE_MASTER_ENDPOINT"])
    master_addr, master_port = master_endpoint.rsplit(":", 1)

    # bind the request server to the interface peers will actually dial
    # (the one that routes to the master) instead of 0.0.0.0 — the
    # unauthenticated-pickle endpoint must not listen on every interface
    # of a multi-homed host (same address that gets registered below)
    ip = os.environ.get("PADDLE_WORKER_IP") or _self_ip(master_addr)
    server = _RpcServer(host=ip)
    store = None
    try:
        store = TCPStore(master_addr, int(master_port),
                         is_master=(rank == 0), world_size=world_size)
        # register the address the server actually BOUND (the loopback
        # fallback may have overridden `ip`) — peers dial what we advertise
        me = WorkerInfo(name, rank, server.host, server.port)
        store.set(f"rpc/worker/{rank}", pickle.dumps(me))

        workers = {}
        for r in range(world_size):
            key = f"rpc/worker/{r}"
            store.wait([key])
            info = pickle.loads(store.get(key))
            if info.name in workers:
                raise RuntimeError(
                    f"duplicate rpc worker name {info.name!r}")
            workers[info.name] = info
    except BaseException:
        # a failed rendezvous must not leak the started server (accept
        # thread, pool, bound port) or the store connection — the caller
        # may retry init_rpc
        server.stop()
        if store is not None:
            try:
                store.close()
            except Exception:
                pass
        raise

    _state.update(store=store, server=server, self=me, workers=workers,
                  pool=ThreadPoolExecutor(max_workers=8,
                                          thread_name_prefix="rpc-client"))
    _barrier("rpc/init")


def _barrier(prefix):
    st = _state["store"]
    n = len(_state["workers"])
    rnd = _state["barrier_round"]
    _state["barrier_round"] += 1
    st.barrier(f"{prefix}/{rnd}", n, _state["self"].rank)


def _require_init():
    if _state["server"] is None:
        raise RuntimeError("rpc is not initialized; call init_rpc first")


def _call(to, fn, args, kwargs, timeout):
    _require_init()
    info = _state["workers"].get(to)
    if info is None:
        raise ValueError(f"unknown rpc worker {to!r}")
    payload = pickle.dumps((fn, tuple(args or ()), dict(kwargs or {})))
    t = _MAX_RPC_TIMEOUT_S if timeout is None or timeout <= 0 else timeout
    with socket.create_connection((info.ip, info.port), timeout=t) as conn:
        conn.settimeout(t)
        _send_msg(conn, payload)
        status, out = pickle.loads(_recv_msg(conn))
    if status == "err":
        raise out
    return out


def rpc_sync(to, fn, args=None, kwargs=None, timeout=-1):
    """Blocking call of `fn(*args, **kwargs)` on worker `to`
    (reference: rpc.py:160)."""
    return _call(to, fn, args, kwargs, timeout)


def rpc_async(to, fn, args=None, kwargs=None, timeout=-1) -> Future:
    """Non-blocking variant returning a future with .wait()/.result()
    (reference: rpc.py:206)."""
    _require_init()
    fut = _state["pool"].submit(_call, to, fn, args, kwargs, timeout)
    fut.wait = fut.result  # paddle futures expose wait()
    return fut


def shutdown():
    """Barrier then stop (reference: rpc.py:305) — the barrier guarantees
    no worker tears down while peers still have calls in flight."""
    if _state["server"] is None:
        return
    # drain OUR outbound calls BEFORE the barrier: a queued rpc_async must
    # not find the peer's server already stopped after everyone passes it
    _state["pool"].shutdown(wait=True)
    _barrier("rpc/shutdown")
    # ack round: the store host (rank 0) must not close the store while a
    # slower rank's barrier WAIT request is still in flight — it waits for
    # every rank's explicit ack, which each rank posts only after its own
    # barrier wait returned
    st, me = _state["store"], _state["self"]
    n = len(_state["workers"])
    try:
        st.set(f"rpc/shutdown_ack/{me.rank}", b"1")
    except RuntimeError:
        # rank 0 stops the store as soon as it has seen every ack, and its
        # stop can overtake the store's reply to this rank's ack (the
        # reference's "TCPStore.set failed"): an ack rank 0 saw is done
        if me.rank == 0:
            raise
    if me.rank == 0:
        st.wait([f"rpc/shutdown_ack/{r}" for r in range(n)])
    _state["server"].stop()
    try:
        _state["store"].close()
    except Exception:
        pass
    _state.update(store=None, server=None, pool=None, self=None, workers={},
                  barrier_round=0)


def get_worker_info(name) -> WorkerInfo:
    _require_init()
    return _state["workers"][name]


def get_all_worker_infos():
    _require_init()
    return sorted(_state["workers"].values(), key=lambda w: w.rank)


def get_current_worker_info() -> WorkerInfo:
    _require_init()
    return _state["self"]
