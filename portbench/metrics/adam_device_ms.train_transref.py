"""adam_device_ms.train_transref: the median, over the traced window's steps,
of the device ms of the span `transref.adam` under the root span
`transref.step`: Adam's update of TransRef's 43.1M parameters. Nothing
where the program records no such step."""

from portbench.yardstick.spans import median, per_root


def read(layer):
    return median(per_root(layer.get("program"), "transref.step",
                           ["transref.adam"], "device_ms"))
