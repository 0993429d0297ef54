"""align_batch_ms.eval: the median, over the window's batches, of the
benchmark's synchronised span around the evaluation step it hands
`validate_with_model` (the alignment of one batch: the homography net,
FlowFormer++ both ways, the warp and the coverage)."""

import statistics


def read(layer):
    spans = layer.get("spans", {}).get("eval_step_ms")
    return statistics.median(spans) if spans else None
