"""TCPStore, the rendezvous key-value store (↔ paddle_tpu/distributed/store.py),
backed by the port's copy of the native C++ server
(`csrc/host/tcp_store.cc`, built by `framework.native`; reference:
paddle/phi/core/distributed/store/tcp_store.h:121 and python
create_or_get_global_tcp_store, python/paddle/distributed/collective.py:342).

The master rank hosts the server; every rank (master included) connects as
a client. The store carries the elastic manager's heartbeats and reform
generation, the rpc rendezvous, the store-based group reduce and
point-to-point of `eager_multiproc`, and barriers.

**Ports.** One master address ("host:port": PADDLE_MASTER, else
MASTER_ADDR and MASTER_PORT) serves two rendezvous. torch's c10d store,
which `init_parallel_env` starts through `tcp://host:port`, takes the
master port itself; this native store takes the master port + 1
(`STORE_PORT_OFFSET`). So both rank-0 servers can run in one process, and
the launcher (`distributed.launch`) picks a master port whose successor is
free as well.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading
import time

from ..framework import native

__all__ = ["STORE_PORT_OFFSET", "TCPStore", "create_or_get_global_tcp_store",
           "master_endpoint"]

# the global store's port is the master port + this; c10d takes the master
# port (distributed/env.py)
STORE_PORT_OFFSET = 1


def _connect_with_backoff(lib, host, port, timeout_ms, io_timeout_ms):
    """Connect with bounded exponential backoff inside the overall timeout.

    Workers racing the master's bind at pod start is the common elastic
    failure: on a restart every worker reconnects at once while rank 0 is
    still binding the server socket, so the first attempts get
    ECONNREFUSED and must retry. Each attempt gets a fresh socket (the
    native connect loop reuses its fd across connect() calls, and POSIX
    leaves a socket's state undefined after a failed connect). Returns
    (fd, attempts)."""
    deadline = time.monotonic() + timeout_ms / 1000.0
    delay = 0.05
    attempt = 0
    while True:
        attempt += 1
        remaining_ms = max(1, int((deadline - time.monotonic()) * 1000))
        # early attempts are short (ECONNREFUSED returns at once while the
        # master has not bound); later ones get 3 s, so that a SYN dropped
        # by a full listen backlog rides out the ~1 s kernel retransmit
        per_attempt_ms = 500 if attempt <= 3 else 3000
        fd = lib.tcp_store_connect(host.encode(), int(port),
                                   min(remaining_ms, per_attempt_ms),
                                   io_timeout_ms)
        if fd >= 0:
            return fd, attempt
        if time.monotonic() + delay >= deadline:
            return fd, attempt
        if attempt == 1 or attempt % 8 == 0:
            print(f"[tcp_store] connect to {host}:{port} refused "
                  f"(attempt {attempt}), retrying for another "
                  f"{deadline - time.monotonic():.1f}s", file=sys.stderr)
        time.sleep(delay)
        delay = min(delay * 2, 1.0)


class TCPStore:
    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=30, io_timeout=900):
        """`timeout` bounds connect(); `io_timeout` bounds each blocking
        GET/WAIT (rendezvous waits may run minutes while stragglers start;
        the reference's default is 900 s, tcp_store.h:121). A timed-out
        request desynchronizes the connection: treat it as fatal. The host
        library is built at first use; a failed build raises naming the
        compiler's output."""
        lib = native.load()
        self._lib = lib
        self._server = None
        self._host = host
        self._timeout_ms = int(timeout * 1000)
        if is_master:
            self._server = lib.tcp_store_server_start(int(port))
            if not self._server:
                raise RuntimeError(f"TCPStore: cannot bind port {port}")
            port = lib.tcp_store_server_port(self._server)
        self._port = int(port)
        self._fd, attempts = _connect_with_backoff(
            lib, host, self._port, self._timeout_ms, int(io_timeout * 1000))
        if self._fd < 0:
            if self._server:
                lib.tcp_store_server_stop(self._server)
                # cleared, so that close() from __del__ does not stop (and
                # free) the server a second time
                self._server = None
            raise RuntimeError(
                f"TCPStore: cannot connect to {host}:{port} after "
                f"{attempts} attempt(s) over {self._timeout_ms / 1000:.0f}s")
        self._lock = threading.Lock()

    @property
    def port(self):
        return self._port

    def set(self, key: str, value):
        if isinstance(value, str):
            value = value.encode()
        with self._lock:
            rc = self._lib.tcp_store_set(self._fd, key.encode(), value,
                                         len(value))
        if rc != 0:
            raise RuntimeError("TCPStore.set failed")

    def _read(self, fn, key):
        """fn's reply for `key` (value length, or a negative code), and its
        buffer, grown while the value outgrows it between round trips."""
        cap = 1 << 20
        with self._lock:
            for _ in range(8):
                buf = ctypes.create_string_buffer(cap)
                n = fn(self._fd, key.encode(), buf, cap)
                if n <= cap:
                    return n, buf
                cap = int(n)
        raise RuntimeError(f"TCPStore: the value of {key!r} kept outgrowing "
                           "the buffer")

    def get(self, key: str) -> bytes:
        n, buf = self._read(self._lib.tcp_store_get, key)
        if n < 0:
            raise RuntimeError("TCPStore.get failed")
        return buf.raw[:n]

    def tryget(self, key: str):
        """Non-blocking probe: the value's bytes, or None when the key is
        absent (the elastic liveness scan: a blocking GET on a dead node's
        heartbeat would stall the whole watch)."""
        n, buf = self._read(self._lib.tcp_store_tryget, key)
        if n == -2:
            return None
        if n < 0:
            raise RuntimeError("TCPStore.tryget failed")
        return buf.raw[:n]

    def add(self, key: str, amount: int) -> int:
        out = ctypes.c_longlong(0)
        with self._lock:
            rc = self._lib.tcp_store_add(self._fd, key.encode(), int(amount),
                                         ctypes.byref(out))
        if rc != 0:
            raise RuntimeError("TCPStore.add failed")
        return int(out.value)

    def wait(self, keys):
        if isinstance(keys, str):
            keys = [keys]
        for k in keys:
            with self._lock:
                rc = self._lib.tcp_store_wait(self._fd, k.encode())
            if rc != 0:
                raise RuntimeError(f"TCPStore.wait({k}) failed")

    def delete_key(self, key: str):
        with self._lock:
            self._lib.tcp_store_delete(self._fd, key.encode())

    def barrier(self, prefix: str, world_size: int, rank: int):
        """Counter barrier: every rank adds 1, waits for the done key."""
        n = self.add(f"{prefix}/count", 1)
        if n >= world_size:
            self.set(f"{prefix}/done", b"1")
        self.wait(f"{prefix}/done")

    def close(self):
        # getattr: __del__ reaches here for instances whose __init__ raised
        # before these attributes existed (a failed bind)
        if getattr(self, "_fd", -1) >= 0:
            self._lib.tcp_store_close(self._fd)
            self._fd = -1
        if getattr(self, "_server", None):
            self._lib.tcp_store_server_stop(self._server)
            self._server = None

    def __del__(self):
        try:
            self.close()
        except Exception as e:
            # never raise out of GC, never swallow silently: a failed close
            # can leak the server socket and wedge the next rendezvous on
            # this port
            try:
                print(f"[tcp_store] warning: close failed during GC: {e!r}",
                      file=sys.stderr)
            except Exception:  # interpreter teardown: stderr may be gone
                pass


_global_store = None


def master_endpoint():
    """(host, master port) from PADDLE_MASTER ("host:port"), else
    MASTER_ADDR and MASTER_PORT (default 6170, the reference's)."""
    master = os.environ.get("PADDLE_MASTER") or os.environ.get(
        "MASTER_ADDR", "127.0.0.1")
    if ":" in master:
        host, port = master.rsplit(":", 1)
        return host, int(port)
    return master, int(os.environ.get("MASTER_PORT", "6170"))


def create_or_get_global_tcp_store():
    """reference: python/paddle/distributed/collective.py:342. The store of
    the job at the master port + STORE_PORT_OFFSET; rank 0
    (PADDLE_TRAINER_ID, else RANK) hosts it."""
    global _global_store
    if _global_store is not None:
        return _global_store
    host, port = master_endpoint()
    rank = int(os.environ.get("PADDLE_TRAINER_ID", os.environ.get("RANK", "0")))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM",
                               os.environ.get("WORLD_SIZE", "1")))
    _global_store = TCPStore(host, port + STORE_PORT_OFFSET,
                             is_master=(rank == 0), world_size=world)
    return _global_store
