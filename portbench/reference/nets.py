"""The reference's homography net and FlowFormer++ at a configuration's
widths, filled from the configuration's weights: the tracked npz snapshot,
or (for tests at sizes the snapshot does not fit) PyTorch's own
initializers seeded from a number."""

from __future__ import annotations

import os
from typing import Dict, Mapping

import torch
import torch.nn as nn

from .flowformer import FlowFormer, FlowFormerConfig
from .layers import train_batch_statistics
from .udis2 import UDIS2HomographyNet
from .weights import load_jax_params, load_npz


def flow_config(cfg: Mapping, upsample_all: bool) -> FlowFormerConfig:
    return FlowFormerConfig(**cfg["flowformer"], upsample_all=upsample_all)


def build_nets(cfg: Mapping, root: str, upsample_all: bool = False
               ) -> Dict[str, nn.Module]:
    """{"homo", "flow"} in fp32 on the CPU, weights as `cfg["weights"]`
    says: {"npz": <path under root>} or {"seeded": <int>}."""
    w = cfg["weights"]
    if "seeded" in w:
        torch.manual_seed(int(w["seeded"]))
    nets = {"homo": UDIS2HomographyNet(input_size=cfg["image_size"]),
            "flow": FlowFormer(flow_config(cfg, upsample_all))}
    if "npz" in w:
        tree = load_npz(os.path.join(root, w["npz"]))
        for k, m in nets.items():
            load_jax_params(m, tree[k])
    return nets


def seeded_state(cfg: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """The state dicts of `build_nets` for seeded weights, which the
    benchmark hands the program's nets too."""
    return {k: m.state_dict() for k, m in build_nets(cfg, "").items()}


def trained_params(nets: Dict[str, nn.Module]) -> Dict[str, torch.Tensor]:
    """The trained tensors keyed "<net>.<name>", the homography net's
    BatchNorm statistics among them (as stitchax trains them)."""
    for m in nets.values():
        train_batch_statistics(m)
    return {f"{k}.{n}": p for k, m in nets.items()
            for n, p in m.named_parameters()}
