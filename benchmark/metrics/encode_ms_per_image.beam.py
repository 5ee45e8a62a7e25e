"""``encode_ms_per_image`` of the beam cells: ``serve_metrics.encode_ms_per_image``."""

from benchmark.serve_metrics import encode_ms_per_image as read  # noqa: F401
