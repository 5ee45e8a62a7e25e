"""User scripts of the port: ``python -m cxrmate_torch.scripts.<name> --help``."""
