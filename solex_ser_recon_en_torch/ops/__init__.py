"""Device operations on tensors; CUDA kernels with their plain versions."""
