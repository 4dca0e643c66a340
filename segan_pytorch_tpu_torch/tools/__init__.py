"""Command-line tools of the port (``python -m segan_pytorch_tpu_torch.tools.<name>``)."""
