"""Config assembly for the CLIs (port of stitchax/run/config.py).

argparse flags merged with the python-module configs at the repo root:
`inf_configs.<inf_cfg>` (plain dicts, shared with stitchax) and
`configs.<model_config_name>`, in stitchax's order, so that the resolved
`CfgNode` and its dump equal stitchax's for the same flags.
"""

from __future__ import annotations

import importlib

from ..utils.config import CfgNode


def _load_module_attr(module_name: str, attr: str):
    return getattr(importlib.import_module(module_name), attr)


def build_out_config(args) -> CfgNode:
    """The stitch CLI's config: `inf_configs.<inf_cfg>`'s inference
    config, merged with the flags, merged with `configs.<model_config_name>`,
    plus TPS_PIPELINE_CONFIG built from the merged config."""
    inf_mod = f"inf_configs.{args.inf_cfg}"
    get_inference_config = _load_module_attr(inf_mod, "get_infernce_config")
    get_tps_config = _load_module_attr(inf_mod, "get_tps_pipline_config")

    cfg = CfgNode(get_inference_config())
    cfg.merge_from_dict(vars(args))
    cfg.merge_from_dict(_load_module_attr(
        f"configs.{args.model_config_name}", "config_dict"))
    cfg.batch_size = 1
    cfg.restore_ckpt = args.ckpt_path
    cfg.TPS_PIPELINE_CONFIG = CfgNode(get_tps_config(cfg))
    return cfg


def build_eval_config(args) -> CfgNode:
    """The evaluation CLI's config: `configs.<model_config_name>` merged
    with the flags that are set (an unset flag must not erase a model
    config value such as image_size)."""
    cfg = CfgNode(_load_module_attr(f"configs.{args.model_config_name}",
                                    "config_dict"))
    cfg.merge_from_dict({k: v for k, v in vars(args).items()
                         if v is not None})
    cfg.batch_size = getattr(args, "batch_size", 12)
    if getattr(args, "ckpt_path", None):
        cfg.restore_ckpt = args.ckpt_path
    return cfg
