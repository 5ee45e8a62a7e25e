"""``mfu`` of the beam cells: ``serve_metrics.mfu``."""

from benchmark.serve_metrics import mfu as read  # noqa: F401
