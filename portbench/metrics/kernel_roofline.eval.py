"""kernel_roofline.eval: K1, K3 and K4's summed least time (the frozen
counts of `yardstick.kernels`, fp32 at 3xTF32's rate) over their summed
device time in the profiled batch, in %; nothing where the trace lost
launches that the program's counters saw."""

from portbench.harness import kernel_share


def read(layer):
    return kernel_share(layer)
