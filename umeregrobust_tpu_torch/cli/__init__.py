"""Command-line entry points of the port (python -m
umeregrobust_tpu_torch.cli.evaluate, python -m
umeregrobust_tpu_torch.cli.sem_preprocessing)."""
