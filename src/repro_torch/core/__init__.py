"""The paper's math on torch tensors: closed forms, wireless parameters,
the convergence bound and block pruning."""
