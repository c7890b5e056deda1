"""int8 matrix product with row / column dequantization: hand-written Hopper
kernel + plain PyTorch version."""
