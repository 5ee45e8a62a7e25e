"""``device_idle_share`` of the greedy cells: ``serve_metrics.device_idle_share``."""

from benchmark.serve_metrics import device_idle_share as read  # noqa: F401
