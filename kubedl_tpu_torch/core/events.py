"""Event types (copied from ``kubedl_tpu/core/events.py``: only the two
constants the SLO evaluator hands its ``recorder``; the port keeps no
event store of its own, so ``recorder`` is any object with the JAX
``Recorder.event(obj, event_type, reason, message)`` verb)."""

TYPE_NORMAL = "Normal"
TYPE_WARNING = "Warning"
