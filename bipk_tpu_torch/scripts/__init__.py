"""Entry points of the port's example experiments (``python -m
bipk_tpu_torch.scripts.<name>``)."""
