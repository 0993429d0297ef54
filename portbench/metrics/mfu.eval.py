"""mfu.eval: the model FLOPs of the pairs evaluated per second in the
window (frozen, `yardstick/flops/<config>.json`) over the peak that keeps
the configuration's accuracy (fp32: 3xTF32, 165 TFLOP/s), in %."""


def read(layer):
    if "items_per_s" not in layer:
        return None
    return (100.0 * layer["items_per_s"] * layer["flops_per_item"]
            / layer["peak_flops"])
