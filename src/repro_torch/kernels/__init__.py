"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``block_norms`` (tile norms) and ``fleet_fused`` (fused pruned
client gradients).  ``build`` compiles ``csrc/`` with nvcc at first use."""
