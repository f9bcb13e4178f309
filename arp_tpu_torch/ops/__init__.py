"""Tensor operations of the port: masks, attention (kernel K1), preprocessing, rewards."""
