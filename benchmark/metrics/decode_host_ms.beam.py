"""``decode_host_ms`` of the beam cells: ``program_trace.decode_host_ms``."""

from benchmark.program_trace import decode_host_ms, reader

read = reader(decode_host_ms)
