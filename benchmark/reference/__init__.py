"""The plain reference (PyTorch only, nothing of the program) and the
comparison that decides ``correct``."""
