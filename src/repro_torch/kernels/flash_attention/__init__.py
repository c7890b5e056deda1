"""Flash attention (forward): hand-written Hopper kernel + plain PyTorch version."""
