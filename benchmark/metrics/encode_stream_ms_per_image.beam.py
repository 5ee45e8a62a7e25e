"""``encode_stream_ms_per_image`` of the beam cells:
``program_trace.encode_stream_ms_per_image``."""

from benchmark.program_trace import encode_stream_ms_per_image, reader

read = reader(encode_stream_ms_per_image)
