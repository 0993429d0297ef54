"""The benchmark's yardstick, frozen: the card's published peaks, the
kernels' operation and byte counts, the model FLOPs of each configuration,
and the reduction of a profiler trace to busy time and kernel time."""
