"""Standalone speculative decoding (``kubedl_tpu/serving/speculative.py``).

Not ported yet: ROADMAP A9. The predictor does not use it —
``KUBEDL_SERVING_SPEC_K`` turns on the continuous-batching engine's
speculative lanes (``serving/batching.py``), which are ported.
"""

from __future__ import annotations


class SpeculativeEngine:
    """Refused by name until ROADMAP A9 ports it."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SpeculativeEngine (single-sequence speculative decoding) is "
            "not ported yet: ROADMAP A9; speculative serving runs on "
            "ContinuousBatchingEngine(draft_config=..., draft_params=..., "
            "spec_k=...)")
