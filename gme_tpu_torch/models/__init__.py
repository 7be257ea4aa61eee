"""Models of the PyTorch port; each mirrors its `gme_tpu.models` namesake."""
