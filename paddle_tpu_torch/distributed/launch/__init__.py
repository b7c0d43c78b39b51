"""python -m paddle_tpu_torch.distributed.launch: the process launcher and
its restart loop (↔ paddle_tpu/distributed/launch/; `main.py`)."""
