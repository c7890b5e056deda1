"""Selective scan (Mamba-1): hand-written Hopper kernel + plain PyTorch version."""
