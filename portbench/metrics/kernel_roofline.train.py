"""kernel_roofline.train: K1, K3 and K4's forwards under grad and in the
no-grad backward flow call: their summed least time (the frozen
counts of `yardstick.kernels`, fp32 at 3xTF32's rate) over their summed
device time in the profiled step, in %; nothing where the trace lost
launches that the program's counters saw."""

from portbench.harness import kernel_share


def read(layer):
    return kernel_share(layer)
