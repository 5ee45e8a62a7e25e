"""Process start to the first timed batch: imports, the CUDA context, the
weights and inputs made on the device, the program's loader, and the warm-up
batch (with the kernels' build on a checkout's first run)."""


def read(r):
    return r["setup_s"]
