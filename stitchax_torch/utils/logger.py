"""The CLIs' logger and the training dashboard (port of
stitchax/utils/logger.py).

Console lines go to stderr with the seconds since the logger started;
metrics go one JSON record per line to `{log_dir}/{name}_metrics.jsonl`,
as stitchax writes them, and to an optional `sink` callable. `push` keeps
running windows and prints their means every `sum_freq` steps.
`save_train_dashboard` draws stitchax's figure of a training step (inputs,
flow maps, the flow-warped image2 and the average blend), `save_flow_panel`
its panel of the inputs, the flow's colour image and a warp, and
`save_flow_quiver` its flow-magnitude heat map with arrows; matplotlib is
imported only there. The panel and the quiver go through the port's JPEG
writer (`io.jpeg`): the figure's pixels are stitchax's, rendered at 80
dpi.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict, deque
from typing import Any, Callable, Dict, Optional

import numpy as np


class Logger:
    def __init__(self, log_dir: str = ".", name: str = "stitchax_torch",
                 sum_freq: int = 100, window: int = 100,
                 sink: Optional[Callable[[Dict[str, Any]], None]] = None):
        self.name = name
        self.sum_freq = sum_freq
        self.window = window
        self.sink = sink
        self._running = defaultdict(lambda: deque(maxlen=window))
        self._step = 0
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, f"{name}_metrics.jsonl"),
                           "a", buffering=1)
        self._t0 = time.time()

    def info(self, msg: str):
        t = time.time() - self._t0
        print(f"[{self.name} +{t:8.1f}s] {msg}", file=sys.stderr, flush=True)

    def push(self, metrics: Dict[str, Any], step: Optional[int] = None):
        """Append the step's metrics to the running windows and the file."""
        self._step = self._step + 1 if step is None else step
        rec = {"step": self._step, "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            v = float(v)
            self._running[k].append(v)
            rec[k] = v
        self._jsonl.write(json.dumps(rec) + "\n")
        if self.sink:
            self.sink(rec)
        if self._step % self.sum_freq == 0:
            avg = {k: sum(d) / len(d) for k, d in self._running.items()}
            pretty = " ".join(f"{k}={v:.4g}" for k, v in avg.items())
            self.info(f"step {self._step}: {pretty}")

    def write_dict(self, d: Dict[str, Any], step: Optional[int] = None):
        """One record of `d` at `step` (default: the last pushed)."""
        rec = {"step": step if step is not None else self._step}
        rec.update({k: float(v) for k, v in d.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        if self.sink:
            self.sink(rec)

    def close(self):
        self._jsonl.close()


class NullLogger:
    """A data-parallel trainer's logger on the ranks other than 0, which
    write no files and print nothing."""

    def info(self, msg: str):
        pass

    def push(self, metrics: Dict[str, Any], step: Optional[int] = None):
        pass

    def close(self):
        pass


def save_train_dashboard(path: str, image1, image2, flow_pred,
                         valid=None, flow_gt=None):
    """stitchax's training figure (its logger.py:69-128): a row of inputs
    (and validity), then for the ground-truth flow (when given) and the
    prediction: the x and y flow maps (colour range clamped to +-200), the
    flow-warped image2 and the average blend. Arrays: images HWC in
    [0, 255], flows HW2, valid HW."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    from ..ops.flow import flow_warp_b

    def row_for(flow):
        fx, fy = np.asarray(flow[..., 0]), np.asarray(flow[..., 1])
        warped = flow_warp_b(
            torch.from_numpy(np.array(image2, np.float32))[None],
            torch.from_numpy(np.array(flow, np.float32))[None])[0].numpy()
        if valid is not None:
            warped = warped * np.asarray(valid)[..., None]
        blend = np.clip((np.asarray(image1, np.float64) + warped) / 2,
                        0, 255).astype("uint8")
        return fx, fy, np.clip(warped, 0, 255).astype("uint8"), blend

    vmin_fn = lambda a: max(-200.0, float(a.min()))
    vmax_fn = lambda a: min(200.0, float(a.max()))
    rows = [("pred", row_for(flow_pred))]
    if flow_gt is not None:
        rows.insert(0, ("gt", row_for(flow_gt)))

    n = 1 + len(rows)
    fig, axs = plt.subplots(n, 4, figsize=(16, 4 * n), squeeze=False)
    axs[0, 0].imshow(np.clip(image1, 0, 255).astype("uint8"))
    axs[0, 0].set_title("image1")
    axs[0, 1].imshow(np.clip(image2, 0, 255).astype("uint8"))
    axs[0, 1].set_title("image2")
    if valid is not None:
        axs[0, 2].imshow(np.asarray(valid), cmap="gray", vmin=0, vmax=1)
        axs[0, 2].set_title("valid")
    axs[0, 3].axis("off")
    for r, (label, (fx, fy, warped, blend)) in enumerate(rows, start=1):
        axs[r, 0].imshow(fx, vmin=vmin_fn(fx), vmax=vmax_fn(fx))
        axs[r, 0].set_title(
            f"{label} flow x  [{fx.min():.1f}, {fx.max():.1f}]")
        axs[r, 1].imshow(fy, vmin=vmin_fn(fy), vmax=vmax_fn(fy))
        axs[r, 1].set_title(
            f"{label} flow y  [{fy.min():.1f}, {fy.max():.1f}]")
        axs[r, 2].imshow(warped)
        axs[r, 2].set_title(f"{label} warped image2")
        axs[r, 3].imshow(blend)
        axs[r, 3].set_title(f"{label} avg blend")
    for ax in axs.ravel():
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def _figure_rgb(fig, dpi: int = 80) -> np.ndarray:
    """The figure as `savefig(..., dpi=dpi)` renders it, (H, W, 3) uint8."""
    import io

    buf = io.BytesIO()
    fig.savefig(buf, format="rgba", dpi=dpi)
    w, h = (int(round(v * dpi)) for v in fig.get_size_inches())
    return np.frombuffer(buf.getvalue(), np.uint8).reshape(h, w, 4)[..., :3]


def save_flow_panel(path: str, image1, image2, flow, warped=None) -> str:
    """stitchax's training panel (its logger.py:131-154): image1, image2,
    the flow's colour image and, when given, the warped image, side by
    side, titled; written to `path` as JPEG. Arrays HWC in [0, 255], the
    flow HW2."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..data.flow_viz import flow_to_image
    from ..io import jpeg

    panels = [("image1", np.clip(image1, 0, 255).astype("uint8")),
              ("image2", np.clip(image2, 0, 255).astype("uint8")),
              ("flow", flow_to_image(np.asarray(flow)))]
    if warped is not None:
        panels.append(("warped", np.clip(warped, 0, 255).astype("uint8")))
    fig, axes = plt.subplots(1, len(panels), figsize=(4 * len(panels), 4))
    for ax, (title, img) in zip(np.atleast_1d(axes), panels):
        ax.imshow(img)
        ax.set_title(title)
        ax.axis("off")
    fig.tight_layout()
    jpeg.write(path, _figure_rgb(fig))
    plt.close(fig)
    return path


def save_flow_quiver(path: str, flow, step: int = 20) -> str:
    """stitchax's flow figure (its logger.py:157-181): the flow's magnitude
    as a heat map with a colour bar and white arrows every `step` pixels;
    written to `path` as JPEG. `flow` HW2, xy-last."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..io import jpeg

    flow = np.asarray(flow)
    mag = np.hypot(flow[..., 0], flow[..., 1])
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(mag)
    fig.colorbar(im, ax=ax)
    ys = np.arange(0, flow.shape[0], step)
    xs = np.arange(0, flow.shape[1], step)
    ax.quiver(xs, ys, flow[::step, ::step, 0], flow[::step, ::step, 1],
              color="white", angles="xy", scale_units="xy")
    ax.set_axis_off()
    fig.tight_layout()
    jpeg.write(path, _figure_rgb(fig))
    plt.close(fig)
    return path
