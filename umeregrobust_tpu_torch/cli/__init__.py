"""Command-line entry points of the port (python -m
umeregrobust_tpu_torch.cli.evaluate)."""
