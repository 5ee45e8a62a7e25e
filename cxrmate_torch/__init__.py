"""PyTorch + CUDA port of cxrmate_tpu for NVIDIA Hopper.

Serves the multi-image report path (CvT-21 encode, BERT greedy and beam-4
decoding) through hand-written CUDA kernels (``csrc/``), each held against a
plain PyTorch version. Imports neither JAX nor ``cxrmate_tpu``."""
