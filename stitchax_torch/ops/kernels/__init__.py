"""Hand-written CUDA kernels (csrc/*.cu) with their plain PyTorch versions."""
