"""stitchax_torch: PyTorch/CUDA port of stitchax for NVIDIA H100."""
