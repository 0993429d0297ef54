"""grad_ms.train: the median, over the window's steps, of the train step's
own synchronised spans (`timings`) forward + no-grad backward flow +
backward."""

import statistics


def read(layer):
    spans = layer.get("spans", {}).get("grad_ms")
    return statistics.median(spans) if spans else None
