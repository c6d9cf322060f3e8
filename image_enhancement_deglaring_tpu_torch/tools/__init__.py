"""Command-line tools of the port (``python -m image_enhancement_deglaring_tpu_torch.tools.<name>``)."""
