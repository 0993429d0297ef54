"""refpa_device_ms.train_transref: the median, over the traced window's
steps, of the summed device ms of the spans `transref.refpa` under the
root span `transref.step` (three a forward: RefPA in encoder stages 1-3,
each an offset estimator, the deformable 3x3 convolution's gathers and
matmul, and the gated fusion). Nothing where the program records no such
step."""

from portbench.yardstick.spans import median, per_root


def read(layer):
    return median(per_root(layer.get("program"), "transref.step",
                           ["transref.refpa"], "device_ms"))
