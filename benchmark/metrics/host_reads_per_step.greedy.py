"""``host_reads_per_step`` of the greedy cells: ``program_trace.host_reads_per_step``."""

from benchmark.program_trace import host_reads_per_step, reader

read = reader(host_reads_per_step)
