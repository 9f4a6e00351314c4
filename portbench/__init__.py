"""The benchmark of the PyTorch and CUDA port, interpn_tpu_torch: see README.md."""
