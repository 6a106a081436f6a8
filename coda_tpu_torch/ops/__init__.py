"""Tensor ops of the port: the P(best) integral, confusion priors, masked
selection, and the CUDA kernels with their plain versions."""
