"""The rank cases of `paddle_tpu_torch.distributed.eager_multiproc`, run by
the 2-rank gloo group of `tests/test_torch_collective.py` (suite
"collective" of `tests/torch_dist_worker.py`): the host-value collectives
over the default group, and the subgroup reduce and point-to-point over
a native TCPStore that rank 0 hosts on a port of its own choosing, which
it broadcasts over the group. Imports numpy, torch and the port only."""

import traceback

import numpy as np

from paddle_tpu_torch.distributed import eager_multiproc as em
from paddle_tpu_torch.distributed.store import TCPStore


def eager_multiproc_cases(rank, world, inp):
    out = {}

    def case(name, fn):
        try:
            out[name] = fn()
        except Exception:  # the case's test reports the traceback
            out[name] = "ERROR " + traceback.format_exc()

    vals = np.asarray([rank + 1.5, -2.0 * rank, 3.0], np.float32)
    case("em_world", lambda: (em.nprocs(), em.rank()))
    case("em_allgather", lambda: em.allgather_values(
        np.asarray([rank, 10 * rank], np.int64)))
    case("em_allgather_bool", lambda: em.allgather_values(
        np.asarray([rank == 0, True])))
    for op in ("sum", "max", "min", "prod", "avg"):
        case(f"em_allreduce_{op}", lambda op=op: em.allreduce_value(vals, op))
    case("em_allreduce_int_avg", lambda: em.allreduce_value(
        np.asarray([rank, 3], np.int32), "avg"))
    case("em_allgather_objects", lambda: em.allgather_objects(
        {"r": rank, "s": "x" * (rank + 3)}))
    case("em_broadcast", lambda: em.broadcast_value(
        np.full((3,), 7.0 * rank, np.float32), src=1))
    case("em_broadcast_objects", lambda: em.broadcast_objects(
        {"from": rank}, src=1))
    case("em_barrier", lambda: (em.barrier(), True)[1])
    case("em_alltoall", lambda: em.alltoall_single_value(
        np.arange(8, dtype=np.float32).reshape(4, 2) + 100 * rank, world))

    def store_cases():
        store = (TCPStore("127.0.0.1", 0, is_master=True, world_size=world)
                 if rank == 0 else None)
        port = em.broadcast_objects(store.port if rank == 0 else None, src=0)
        if rank != 0:
            store = TCPStore("127.0.0.1", port, world_size=world, timeout=60)
        res = {"rounds": [em.store_allreduce_group(
            store, np.asarray([rank + r, 1.0]), [1, 0], "sum", gid=7).tolist()
            for r in range(3)]}
        res["live_before"] = [store.tryget(f"gar/0,1#g7/{s}/{rank}")
                              is not None for s in range(3)]
        if rank == 0:
            em.p2p_send(store, np.arange(3) * 2, 0, 1)
            em.p2p_send(store, np.ones(2), 0, 1)
        else:
            res["recv"] = [em.p2p_recv(store, 0, 1).tolist(),
                           em.p2p_recv(store, 0, 1).tolist()]
            res["consumed"] = store.tryget("p2p/0->1/0")
        store.barrier("eager/done", world, rank)
        em.cleanup_group_keys(store, gid=7)
        res["live_after"] = [store.tryget(f"gar/0,1#g7/{s}/{rank}")
                             is not None for s in range(3)]
        # over the group, not the store: rank 0 stops the store's server
        # only once every rank has its last reply from it
        em.barrier()
        store.close()
        return res

    case("em_store", store_cases)
    return out
