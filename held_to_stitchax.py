"""How the port is held to stitchax: the readings of a port train step or
stitch against stitchax's committed outputs (tests/torch_reference/).

The CPU tests (tests/test_torch_*.py) and chip_smoke.py's card phases both
take their readings here, so a reading means the same on the CPU and on the
card. Each caller keeps its own limits. numpy and the standard library only:
the card's machine has no JAX.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Union

import numpy as np

# ------------------------------- train steps ---------------------------------
#
# A step reference holds metric/<name> (the losses and each global gradient
# norm), gradnorm/<leaf> for every leaf and, for the kept leaves,
# grad/<leaf> and updated/<leaf>. A leaf is named by stitchax's key string.

# one global norm over every leaf; a caller whose steps norm their leaves
# apart (SD's VAE and diffusion steps) passes {norm metric: key prefixes}
ONE_NORM = {"grad_norm": ("",)}
# Adam's first step is lr g / (|g| + eps): where stitchax's |g| exceeds
# this (100 eps) it is ~lr sign(g) on both sides, below it a gradient's
# rounding moves the step by up to 2 lr
ADAM_G_LARGE = 1e-6


def global_norm(grads: Mapping[str, np.ndarray],
                prefixes: Iterable[str] = ("",)) -> float:
    """The global norm, summed in float64, of the leaves whose key starts
    with one of `prefixes`."""
    prefixes = tuple(prefixes)
    return float(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                             for k, g in grads.items()
                             if k.startswith(prefixes))))


def step_reference(metrics: Mapping[str, float],
                   grads: Mapping[str, np.ndarray],
                   updated: Mapping[str, np.ndarray],
                   kept: Iterable[str]) -> Dict[str, np.ndarray]:
    """A step's reference arrays: metric/<name> of `metrics`,
    gradnorm/<leaf> of every leaf of `grads`, and grad/<leaf> and
    updated/<leaf> of the `kept` leaves."""
    out = {f"metric/{k}": np.float32(v) for k, v in metrics.items()}
    out.update({f"gradnorm/{k}": np.float32(np.linalg.norm(g))
                for k, g in grads.items()})
    for k in kept:
        out[f"grad/{k}"] = grads[k]
        out[f"updated/{k}"] = updated[k]
    return out


def kept_leaves(ref: Mapping[str, np.ndarray]) -> List[str]:
    """The leaves whose gradients and updated values a reference keeps."""
    return [k[len("grad/"):] for k in ref if k.startswith("grad/")]


def l2_rel(got: np.ndarray, want: np.ndarray, floor: float = 0.0) -> float:
    """|got - want|_2 / (|want|_2 + floor)."""
    return (float(np.linalg.norm(got - want))
            / (float(np.linalg.norm(want)) + floor))


def step_readings(metrics: Mapping[str, float],
                  grads: Mapping[str, np.ndarray],
                  ref: Mapping[str, np.ndarray],
                  norms: Mapping[str, Iterable[str]] = ONE_NORM) -> dict:
    """A step's metrics (its losses and the global norms named in `norms`)
    and raw gradients against its reference: "metric_rel", each metric's
    |got - stitchax's| / |stitchax's|, and their largest, "loss_rel" over
    the losses and "grad_norm_rel" over the norms; "leaf_norm_rel", each
    leaf's gradient norm as |norm - stitchax's| / (stitchax's + floor), and
    its worst leaf, "leaf_norm_worst"; "leaf_l2_rel", each kept leaf's
    `l2_rel` to stitchax's gradient. A leaf's floor, 1e-6 of its norm
    group's global norm in the reference, keeps leaves whose gradient
    vanishes from reading as noise. Raises ValueError if the leaves are not
    the reference's."""
    leaves = [k[len("gradnorm/"):] for k in ref if k.startswith("gradnorm/")]
    if sorted(leaves) != sorted(grads):
        raise ValueError("the step's gradient leaves are not the "
                         "reference's")
    floors = [(tuple(p), 1e-6 * float(ref[f"metric/{n}"]))
              for n, p in norms.items()]

    def floor(leaf):
        for prefixes, f in floors:
            if leaf.startswith(prefixes):
                return f
        raise ValueError(f"{leaf} is in no group of {list(norms)}")

    rel = {k: abs(v - float(ref[f"metric/{k}"]))
           / abs(float(ref[f"metric/{k}"])) for k, v in metrics.items()}
    norm = {k: abs(float(np.linalg.norm(grads[k]))
                   - float(ref[f"gradnorm/{k}"]))
            / (float(ref[f"gradnorm/{k}"]) + floor(k)) for k in leaves}
    return {"metric_rel": rel,
            "loss_rel": max(e for k, e in rel.items() if k not in norms),
            "grad_norm_rel": max(e for k, e in rel.items() if k in norms),
            "leaf_norm_rel": norm,
            "leaf_norm_worst": max(norm, key=norm.get),
            "leaf_l2_rel": {k: l2_rel(grads[k], ref[f"grad/{k}"], floor(k))
                            for k in kept_leaves(ref)}}


def adamw_first_step(updated: Mapping[str, np.ndarray],
                     ref: Mapping[str, np.ndarray],
                     start: Mapping[str, np.ndarray], lr0: float) -> dict:
    """The kept leaves after AdamW's first step, in units of lr0 (the step
    is ~lr0 sign(g) but where |g| is near eps): "worst_lr0", the largest
    |diff| from stitchax's value; "over_scale_lr0", the largest less 1e-6
    of its tensor's largest |value|; "off_share", the share of elements off
    by more than 0.01 lr0; "unmoved", the kept leaves equal to `start`."""
    worst = over = 0.0
    off = n = 0
    unmoved = []
    for k in kept_leaves(ref):
        r = ref[f"updated/{k}"]
        d = np.abs(updated[k] - r)
        worst = max(worst, float(d.max()) / lr0)
        over = max(over, float((d - 1e-6 * np.abs(r).max()).max()) / lr0)
        off += int((d > 0.01 * lr0).sum())
        n += d.size
        if not np.any(updated[k] != start[k]):
            unmoved.append(k)
    return {"worst_lr0": worst, "over_scale_lr0": over, "off_share": off / n,
            "unmoved": unmoved}


def adam_step(updated: Mapping[str, np.ndarray],
              ref: Mapping[str, np.ndarray],
              start: Mapping[str, np.ndarray],
              lr: Union[float, Mapping[str, float]]) -> dict:
    """The kept leaves after Adam's first step, in units of lr (one, or
    each kept leaf's): "g_large_lr", the largest |diff| from stitchax's
    value where its |g| > ADAM_G_LARGE; "worst_lr", the largest anywhere;
    "off_share", the share of elements off by more than 0.01 lr;
    "unmoved", the kept leaves equal to `start`."""
    large = worst = 0.0
    off = n = 0
    unmoved = []
    for k in kept_leaves(ref):
        d = (np.abs(updated[k] - ref[f"updated/{k}"])
             / (lr[k] if isinstance(lr, Mapping) else lr))
        big = np.abs(ref[f"grad/{k}"]) > ADAM_G_LARGE
        if big.any():
            large = max(large, float(d[big].max()))
        worst = max(worst, float(d.max()))
        off += int((d > 0.01).sum())
        n += d.size
        if not np.any(updated[k] != start[k]):
            unmoved.append(k)
    return {"g_large_lr": large, "worst_lr": worst, "off_share": off / n,
            "unmoved": unmoved}


# --------------------------------- stitches ----------------------------------

# the canvases a stitch reading compares: stitchax's name -> the port's
CANVASES = {"warp2": "output2", "ave_fusion": "new_blend_image"}


def to_u8(x: np.ndarray) -> np.ndarray:
    """A canvas as stitchax's exact-RGB pack rounds it."""
    return np.rint(np.clip(x, 0, 255)).astype(np.uint8)


def psnr(a, b) -> float:
    """PSNR in dB of two images on the 0-255 scale, in float64; inf where
    they are equal."""
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(255.0 ** 2 / mse))


def _same_canvas(out, ref, true_hw) -> None:
    got = [[int(v) for v in out[k]] for k in ("canvas_hw", "true_hw")]
    want = [[int(v) for v in ref["canvas_hw"]], [int(v) for v in true_hw]]
    if got != want:
        raise ValueError(f"canvas {got[0]} / true {got[1]}, stitchax "
                         f"{want[0]} / {want[1]}")


def stitch_readings(out: Mapping[str, np.ndarray],
                    ref: Mapping[str, np.ndarray],
                    canvases: Mapping[str, str] = CANVASES) -> dict:
    """One pair's stitch (numpy outputs as `Stitcher.stitch` gives them,
    with canvas_hw and true_hw) against stitchax's arrays (its canvases
    cropped to the true canvas, mask1 at the bucketed one): the largest
    |diff| of H, of the flow and its mean, of the canvas bounds; the control
    points whose validity differs, their targets' largest |diff| over every
    point and over those both sides mark valid ("control_dst_valid_max_px");
    mask1's values that differ (over the port's mask1, cropped or not); and
    for each of `canvases` the PSNR, the largest level difference and the
    count of levels off by more than 1 of its uint8 pack. Raises ValueError
    where the canvases differ in size."""
    th, tw = ref["warp2"].shape[:2]
    _same_canvas(out, ref, (th, tw))
    fd = np.abs(out["flow"] - ref["flow"])
    dst = np.abs(out["control_dst"] - ref["control_dst"])
    h, w = out["mask1"].shape[:2]
    r = {"H_max_abs": float(np.abs(out["H"] - ref["H"]).max()),
         "flow_max_px": float(fd.max()), "flow_mean_px": float(fd.mean()),
         "canvas_box_px": float(np.abs(out["canvas_box"]
                                       - ref["canvas_box"]).max()),
         "control_valid_moved": int((out["control_valid"]
                                     != ref["control_valid"]).sum()),
         "control_dst_max_px": float(dst.max()),
         "control_dst_valid_max_px": float(
             dst[out["control_valid"] & ref["control_valid"]].max()),
         "mask1_moved_px": int((out["mask1"] != ref["mask1"][:h, :w]).sum())}
    for key, ours in canvases.items():
        a = to_u8(out[ours][:th, :tw])
        d = np.abs(a.astype(int) - ref[key].astype(int))
        r[f"{key}_psnr_db"] = psnr(a, ref[key])
        r[f"{key}_max_level"] = int(d.max())
        r[f"{key}_px_off_gt1"] = int((d > 1).sum())
    return r


def worst(readings: Iterable[Mapping[str, float]]) -> Dict[str, float]:
    """The worst of several pairs' readings, key by key: the least of each
    "*_db", the largest of the others."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            worse = min if k.endswith("_db") else max
            out[k] = worse(out.get(k, v), v)
    return out


def composition_readings(out: Mapping[str, np.ndarray],
                         files: Mapping[str, np.ndarray],
                         ref: Mapping[str, np.ndarray]) -> dict:
    """A stitch with the composition net (`Stitcher.stitch`'s numpy outputs
    and the uint8 images `output_images` writes from them) against
    stitchax's arrays: the PSNR of warp2, ave_fusion and the composition,
    the learned masks' mean and largest |diff|, and mask1's values that
    differ. Raises ValueError where the canvases differ in size."""
    th, tw = (int(v) for v in ref["true_hw"])
    _same_canvas(out, ref, (th, tw))
    r = {f"{k}_psnr_db": psnr(files[k], ref[k])
         for k in ("warp2", "ave_fusion", "composition")}
    lm = np.concatenate([np.abs(out[k] - ref[k]).ravel()
                         for k in ("learned_mask1", "learned_mask2")])
    r.update(learned_mask_mean_abs=float(lm.mean()),
             learned_mask_max_abs=float(lm.max()),
             mask1_moved_px=int((out["mask1"]
                                 != ref["mask1"][:th, :tw]).sum()))
    return r


# -------------------------------- evaluation ---------------------------------

def evaluation_readings(per_pair, report: Mapping[str, float],
                        warped: np.ndarray, valid: np.ndarray,
                        ref: Mapping[str, np.ndarray]) -> dict:
    """An evaluation (`validate_with_model`'s [(name, psnr, ssim)] and
    report, and the uint8 warped img2 and coverage by pair index) against
    stitchax's: the largest per-pair PSNR and SSIM gaps, the largest report
    PSNR and SSIM gaps, and over the pairs whose warp the reference keeps
    the largest share of coverage pixels that differ and the largest mean
    level gap of the warps where both cover. Raises ValueError if the pairs
    are not stitchax's."""
    if [p[0] for p in per_pair] != [str(n) for n in ref["names"]]:
        raise ValueError("other pairs than stitchax's")
    got = np.array([p[1:] for p in per_pair])
    res = {"psnr_abs_diff": float(np.abs(got[:, 0] - ref["psnr"]).max()),
           "ssim_abs_diff": float(np.abs(got[:, 1] - ref["ssim"]).max())}
    keys = [k[len("report/"):] for k in ref if k.startswith("report/")]
    for m in ("psnr", "ssim"):
        res[f"report_{m}_abs_diff"] = max(
            abs(report[k] - float(ref[f"report/{k}"])) for k in keys if m in k)
    moved = level = 0.0
    for key in [k for k in ref if k.startswith("valid/")]:
        i = int(key[len("valid/"):])
        v, w = ref[key], ref[f"warped/{i}"]
        both = ((valid[i] == 1) & (v == 1))[..., 0]
        moved = max(moved, float(np.mean(valid[i] != v)))
        d = np.abs(warped[i].astype(int) - w.astype(int))
        level = max(level, float(d[both].mean()))
    res.update(valid_moved_share=moved, warped_mean_level=level)
    return res
