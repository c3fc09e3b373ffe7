"""Hand-written Hopper kernels of the port, their plain PyTorch versions and
the PyTorch oracles they are tested against."""
