"""``decode_step_ms`` of the beam cells: ``serve_metrics.decode_step_ms``."""

from benchmark.serve_metrics import decode_step_ms as read  # noqa: F401
