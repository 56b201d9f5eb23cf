"""Tensor ops of the port: o3 structure, scatter, neighbour lists, the
slot layout and the fused message kernels."""
