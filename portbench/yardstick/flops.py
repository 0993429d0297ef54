"""Model FLOPs of a configuration, counted once on the plain reference and
frozen in `yardstick/flops/<config>.json`:

    python3 -m portbench.yardstick.flops ffpp_udis2_fp32

One pair at the configuration's size, counted by
`torch.utils.flop_counter.FlopCounterMode` (matrix products and
convolutions, 2 FLOPs a multiply-add; elementwise work not counted):
the homography net's forward, FlowFormer++'s forward with only the last
prediction upsampled (the evaluation's and the stitch's calls) and with
all of them (training's). A pair's evaluation is the homography net and
two flow calls; a pair's train step is three times the forward that is
differentiated (forward, and a backward twice its size) plus the flow
call without gradient that gives the occlusion mask.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Mapping

HERE = os.path.dirname(os.path.abspath(__file__))


def count(cfg: Mapping) -> Dict[str, float]:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference.nets import build_nets

    S = cfg["image_size"]
    seeded = dict(cfg, weights={"seeded": 0})
    out = {}
    with torch.no_grad():
        a = torch.rand(1, S, S, 3) * 255
        b = torch.rand(1, S, S, 3) * 255
        for ua in (False, True):
            nets = build_nets(seeded, "", upsample_all=ua)
            with FlopCounterMode(display=False) as fc:
                nets["flow"](a, b)
            out["flow_all" if ua else "flow_last"] = float(fc.get_total_flops())
        with FlopCounterMode(display=False) as fc:
            nets["homo"](a / 127.5 - 1, b / 127.5 - 1)
        out["homo"] = float(fc.get_total_flops())
    out["eval_pair"] = out["homo"] + 2 * out["flow_last"]
    out["train_pair"] = 3 * (out["homo"] + out["flow_all"]) + out["flow_last"]
    return out


def load(config: str) -> Dict[str, float]:
    with open(os.path.join(HERE, "flops", f"{config}.json")) as f:
        return json.load(f)


def main(argv) -> int:
    name = argv[0]
    root = os.path.dirname(os.path.dirname(HERE))
    with open(os.path.join(root, "portbench", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    out = count(cfg)
    with open(os.path.join(HERE, "flops", f"{name}.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
