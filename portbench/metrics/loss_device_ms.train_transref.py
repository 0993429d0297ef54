"""loss_device_ms.train_transref: the median, over the traced window's steps,
of the device ms of the span `transref.loss` under the root span
`transref.step`: the objective (L1, the VGG16 on the prediction and on the
ground truth, the perceptual and style terms). Nothing where the program
records no such step."""

from portbench.yardstick.spans import median, per_root


def read(layer):
    return median(per_root(layer.get("program"), "transref.step",
                           ["transref.loss"], "device_ms"))
