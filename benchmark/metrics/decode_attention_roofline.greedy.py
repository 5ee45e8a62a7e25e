"""``decode_attention_roofline`` of the greedy cells: ``serve_metrics.decode_attention_roofline``."""

from benchmark.serve_metrics import decode_attention_roofline as read  # noqa: F401
