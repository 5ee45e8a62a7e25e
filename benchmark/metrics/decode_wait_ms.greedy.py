"""``decode_wait_ms`` of the greedy cells: ``program_trace.decode_wait_ms``."""

from benchmark.program_trace import decode_wait_ms, reader

read = reader(decode_wait_ms)
