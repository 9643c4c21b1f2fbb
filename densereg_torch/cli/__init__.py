"""The command line of the port: ``python -m densereg_torch.cli.main``."""
