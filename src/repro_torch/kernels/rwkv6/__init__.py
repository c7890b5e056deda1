"""Chunked WKV-6 scan (RWKV-6): hand-written Hopper kernel + plain PyTorch version."""
