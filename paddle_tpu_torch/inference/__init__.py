"""paddle_tpu_torch.inference — the serving API (↔ paddle_tpu/inference).

`create_serving_engine(model)` builds a `PagedServingEngine` on the model's
device, `create_serving_engine(model, paged=False)` the dense
`ContinuousBatchingEngine`. The saved-program Predictor comes with a later
slice (ROADMAP queue A item 8).
"""

from __future__ import annotations

from .serving import ContinuousBatchingEngine, GenerationRequest

__all__ = ["ContinuousBatchingEngine", "GenerationRequest",
           "create_serving_engine"]


def create_serving_engine(model, paged=True, **kw):
    """Generation engine factory: paged=True (the default) builds the
    block-pool `PagedServingEngine`, paged=False the dense
    `ContinuousBatchingEngine`; keyword args pass through to it."""
    if not paged:
        return ContinuousBatchingEngine(model, **kw)
    from .paged import PagedServingEngine

    return PagedServingEngine(model, **kw)
