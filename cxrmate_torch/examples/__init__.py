"""User examples of the port: ``python -m cxrmate_torch.examples.<name> --help``."""
