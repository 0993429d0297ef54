"""stitchax_torch.ops: geometry and image primitives (NHWC, xy-last),
ported from stitchax.ops, plus the hand-written CUDA kernels in
`ops.kernels`."""
