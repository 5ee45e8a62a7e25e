"""``report_studies_per_s`` of the greedy cells: ``serve_metrics.studies_per_s``."""

from benchmark.serve_metrics import studies_per_s as read  # noqa: F401
