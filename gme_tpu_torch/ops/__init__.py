"""Ops of the PyTorch port; each mirrors its `gme_tpu.ops` namesake."""
