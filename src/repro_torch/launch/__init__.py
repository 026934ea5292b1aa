"""Command-line entry points of the package (``python -m repro_torch.launch.<name>``)."""
