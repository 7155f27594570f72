"""Hand-written Hopper kernels, one module each, with their plain PyTorch
versions and launch counters."""
