"""backward_device_ms.train_transref: the median, over the traced window's
steps, of the device ms of the span `transref.backward` under the root span
`transref.step`: the backward (through the VGG16's input gradients and
TransRef, its deformable gathers' scatter-adds among them). Nothing where
the program records no such step."""

from portbench.yardstick.spans import median, per_root


def read(layer):
    return median(per_root(layer.get("program"), "transref.step",
                           ["transref.backward"], "device_ms"))
