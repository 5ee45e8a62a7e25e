"""``beam_reorder_roofline`` of the beam cells: ``serve_metrics.beam_reorder_roofline``."""

from benchmark.serve_metrics import beam_reorder_roofline as read  # noqa: F401
