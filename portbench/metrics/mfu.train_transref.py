"""mfu.train_transref: the model FLOPs of the pairs trained per second in
the traced window (frozen, `yardstick/flops/<config>.json`: TransRef's
forward, the VGG16 on both images and the backward, one pair) over the
peak that keeps the configuration's accuracy (fp32: 3xTF32, 165 TFLOP/s),
in %."""


def read(layer):
    if "items_per_s" not in layer:
        return None
    return (100.0 * layer["items_per_s"] * layer["flops_per_item"]
            / layer["peak_flops"])
