"""Hand-written Hopper kernels of the port and their plain PyTorch versions."""
