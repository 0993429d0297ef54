"""update_ms.train: the median, over the window's steps, of the train
step's own synchronised span of the update (the global-norm clip and
AdamW)."""

import statistics


def read(layer):
    spans = layer.get("spans", {}).get("update_ms")
    return statistics.median(spans) if spans else None
