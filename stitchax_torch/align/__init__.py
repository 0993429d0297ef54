"""Alignment core: homography + residual flow -> canvas warps."""
