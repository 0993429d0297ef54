"""Model FLOPs of a TransRef training configuration, counted once on the
plain reference and frozen in `yardstick/flops/<config>.json`:

    python3 -m portbench.yardstick.flops_transref transref_vgg16_fp32

One pair at the configuration's size (batch 1, seeded weights, on the
CPU), counted by `torch.utils.flop_counter.FlopCounterMode` (matrix
products and convolutions, 2 FLOPs a multiply-add; elementwise work, the
deformable gathers and the pools not counted): TransRef's forward
(`forward`), the VGG16 on the prediction and on the ground truth
(`vgg`), and the backward from the loss through the VGG (input gradients
only: it is frozen) and TransRef (`backward`). `train_pair` is their sum,
one pair's train step; Adam's elementwise update is not counted.
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

    from ..reference.transref import TransRef
    from ..reference.transref_train import prepare_inputs
    from ..reference.vgg import objective, seeded_vgg

    S, l = cfg["image_size"], cfg["loss"]
    torch.manual_seed(0)
    model, vgg = TransRef(), seeded_vgg(0)
    gt = torch.rand(1, S, S, 3) * 2 - 1
    ref = torch.rand(1, S, S, 3) * 2 - 1
    mask = torch.zeros(1, S, S, 1)
    mask[:, S // 4:S // 2, S // 4:S // 2] = 1.0
    out = {}
    with FlopCounterMode(display=False) as fc:
        pred = model(prepare_inputs(gt, mask), mask, ref)
    out["forward"] = float(fc.get_total_flops())
    with FlopCounterMode(display=False) as fc:
        loss = objective(vgg, pred, gt, l["l1"], l["perceptual"],
                         l["style"])["total"]
    out["vgg"] = float(fc.get_total_flops())
    with FlopCounterMode(display=False) as fc:
        loss.backward()
    out["backward"] = float(fc.get_total_flops())
    out["train_pair"] = out["forward"] + out["vgg"] + out["backward"]
    return out


def load(config: str) -> Dict[str, float]:
    with open(os.path.join(HERE, "flops", f"{config}.json")) as f:
        return json.load(f)


def main(argv) -> int:
    import torch

    name = argv[0]
    root = os.path.dirname(os.path.dirname(HERE))
    with open(os.path.join(root, "portbench", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    torch.set_num_threads(min(8, torch.get_num_threads()))
    out = count(cfg)
    with open(os.path.join(HERE, "flops", f"{name}.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
