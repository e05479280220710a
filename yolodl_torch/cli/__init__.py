"""Command-line entry points of the port (``python -m yolodl_torch.cli.<name>``)."""
