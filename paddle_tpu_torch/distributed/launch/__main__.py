"""python -m paddle_tpu_torch.distributed.launch [options] script [args]
(↔ paddle_tpu/distributed/launch/__main__.py; reference:
python/paddle/distributed/launch/main.py:23 and CollectiveController,
controllers/collective.py:22, which builds the pod, exports
PADDLE_TRAINER_ENDPOINTS / PADDLE_MASTER and the rank variables (:126-150)
and spawns one process per device). Here one process per card of the
host (`--nproc_per_node`), each a fresh interpreter; `main.py` has the
environment a worker receives."""

from .main import launch

if __name__ == "__main__":
    launch()
