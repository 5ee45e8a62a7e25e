"""The benchmark of cxrmate_torch, the PyTorch and CUDA port: a harness
driven by the data files beside it (``README.md``)."""
