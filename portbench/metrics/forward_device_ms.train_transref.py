"""forward_device_ms.train_transref: the median, over the traced window's
steps, of the device ms of the span `transref.forward` under the root span
`transref.step`: the TransRef forward (under autograd; `transref.encoder`
with the three RefPA calls and `transref.decoder` inside it). Nothing where
the program records no such step."""

from portbench.yardstick.spans import median, per_root


def read(layer):
    return median(per_root(layer.get("program"), "transref.step",
                           ["transref.forward"], "device_ms"))
