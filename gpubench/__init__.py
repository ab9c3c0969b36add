"""The benchmark of the PyTorch/H100 port, ``multike_tpu_torch`` (README.md)."""
