"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``block_norms`` (tile norms), ``fleet_fused`` (fused pruned client
gradients), ``block_sparse_matmul`` (tile-masked products, forward and
transposed), ``decode_attention`` and ``flash_prefill`` (GQA attention with
dead-head skips), ``mlstm_scan`` and ``slstm_scan`` (the xLSTM cells over a
whole sequence, forward and backward, as custom ops).  ``ops`` wraps them
behind the reference's signatures; ``build`` compiles ``csrc/`` with nvcc
at first use."""
