"""Hand-written CUDA kernels (``csrc/``) with their PyTorch wrappers and
plain PyTorch versions. Nothing here builds or loads a kernel at import
time."""
