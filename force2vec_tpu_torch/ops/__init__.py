"""Device kernels: hand-written CUDA (``csrc/``) with plain PyTorch twins."""
