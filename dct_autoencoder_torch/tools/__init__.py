"""Command-line tools of the port (counterparts of dct_autoencoder_tpu/tools)."""
