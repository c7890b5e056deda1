"""Flash attention: hand-written Hopper kernels (forward and backward) + plain PyTorch versions."""
