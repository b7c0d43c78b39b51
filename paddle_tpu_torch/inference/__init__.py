"""paddle_tpu_torch.inference — the serving API (↔ paddle_tpu/inference).

Only the paged engine is ported: `create_serving_engine(model)` builds a
`PagedServingEngine` on the model's device. The dense continuous-batching
engine (`paged=False`) and the saved-program Predictor come with later
slices (ROADMAP A8, A13).
"""

from __future__ import annotations

from .serving import GenerationRequest

__all__ = ["GenerationRequest", "create_serving_engine"]


def create_serving_engine(model, paged=True, **kw):
    """Generation engine factory. paged=True (the default) builds the
    block-pool `PagedServingEngine`; keyword args pass through to it."""
    if not paged:
        raise NotImplementedError(
            "the dense ContinuousBatchingEngine is ported with a later "
            "serving slice (ROADMAP A8 dense engine)")
    from .paged import PagedServingEngine

    return PagedServingEngine(model, **kw)
