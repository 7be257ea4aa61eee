"""Measurement tools of the port, run as modules (`python -m
gme_tpu_torch.tools.<name>`)."""
