"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the 700 W power limit), and the least time a piece of work can take."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def bound_s(nbytes: float, flops: float, dtype: str):
    """The larger of bytes over the memory rate and operations over the peak
    rate for their type, in seconds, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
