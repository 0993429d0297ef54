"""The SD inpainting trainer's CLI: tools/train_sd_inpaint_learns.py on one
card.

    python -m stitchax_torch.train_sd_inpaint --save_ckpt --out run/

Trains the reduced-scale SD inpainting stack (UNet and ControlNet at
widths (w, 2w), context 2w, the VAE at (w, w, 2w, 2w); 128^2, w = 48 and
batch 8 by default, in fp32 with TF32 off) on rectangle holes over random
crops of demo_data/ and demo_scenes/:

  phase 1  the VAE as an autoencoder (L1 + MSE), then its recon PSNR on
           held-out crops;
  step 0   the whole stack's DDIM inpainting (`make_sd_inpaint_fn`) of the
           held-out crops' holes against the push-pull fill;
  phase 2  UNet + ControlNet on the epsilon objective, the VAE frozen; at
           every --eval_every steps the hole PSNR at full strength and at
           --eval_strength, and with --save_ckpt `sd_ckpt.pt` (the latest,
           with the better strength as preferred_strength) and
           `sd_ckpt_best.pt` (the best refine PSNR).

Writes `result.json` (the tool's keys and its learn checks) and
`panel_final.jpg` (holed input | push-pull | the stack | ground truth)
under --out. The checkpoints are "stitchax_jax" containers, which
`StitchModels.from_npz(..., sd=...)`, STITCHAX_SD_CKPT and stitchax's
load_sd_checkpoint read. The tool's flags, plus `--device` (default
cuda:0; `cpu` for tests).

Where it departs from the tool: the nets start from the port's seeded
initialisers (`sd_inpaint_trainer.init_weights`), not flax's draws; the
holes are drawn from a torch.Generator seeded with seed + 1 (stitchax's
bounds), the context (unless --init_ckpt gives it) from one seeded with
seed + 2, the timesteps and noise from one on the device seeded with
seed + 3, not from jax.random. The crops and the batch order are the
tool's numpy draws from --seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m stitchax_torch.train_sd_inpaint")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "sd_train"))
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--width", type=int, default=48,
                   help="UNet base channels (SD-1.5: 320)")
    p.add_argument("--steps_vae", type=int, default=1500)
    p.add_argument("--steps", type=int, default=6000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr_vae", type=float, default=3e-4)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--n_train", type=int, default=64)
    p.add_argument("--n_eval", type=int, default=8)
    p.add_argument("--eval_every", type=int, default=1000)
    p.add_argument("--eval_ddim_steps", type=int, default=20)
    p.add_argument("--eval_strength", type=float, default=0.35,
                   help="second eval arm: diffusers strength (DDIM starts "
                        "from the noised classical fill)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_ckpt", action="store_true")
    p.add_argument("--init_ckpt", type=str, default=None,
                   help="resume unet/controlnet/vae/context from a saved "
                        "stitchax_jax container; its configs must be "
                        "--width's; --steps_vae 0 keeps its VAE")
    p.add_argument("--device", type=str, default="cuda:0",
                   help="torch device ('cpu' for tests)")
    return p.parse_args(argv)


def load_demo_images(size: int) -> List[np.ndarray]:
    """Every input1 / input2 of demo_data/ and demo_scenes/ resized to
    size^2 as Pillow's BILINEAR resizes it, float32 (size, size, 3)."""
    from ..io import jpeg
    from ..io.resize import resize_bilinear

    demos = []
    for pool in ("demo_data", "demo_scenes"):
        root = os.path.join(REPO, pool)
        if not os.path.isdir(root):
            continue
        for d in sorted(os.listdir(root)):
            for name in ("input1.jpg", "input2.jpg"):
                f = os.path.join(root, d, name)
                if os.path.isfile(f):
                    demos.append(resize_bilinear(jpeg.read_rgb(f), size,
                                                 size).astype(np.float32))
    if not demos:
        raise FileNotFoundError(f"no demo images under {REPO}")
    return demos


def make_crops(size: int, n: int, rng: np.random.Generator,
               pool: Optional[List[np.ndarray]] = None) -> np.ndarray:
    """Random crops, flips and brightness jitter over `pool` (default: the
    demo images at 2 size), float32 in [0, 255] (n, size, size, 3)."""
    if pool is None:
        pool = load_demo_images(2 * size)
    crops = []
    for i in range(n):
        img = pool[i % len(pool)]
        y = rng.integers(0, img.shape[0] - size + 1)
        x = rng.integers(0, img.shape[1] - size + 1)
        c = img[y:y + size, x:x + size]
        if rng.random() < 0.5:
            c = c[:, ::-1]
        c = np.clip(c * rng.uniform(0.85, 1.15), 0, 255)
        crops.append(c.astype(np.float32))
    return np.stack(crops)


def hole_psnr255(out, gt, mask) -> float:
    a, b = np.asarray(out, np.float64), np.asarray(gt, np.float64)
    m = np.asarray(mask, np.float64)
    mse = (((a - b) ** 2) * m).sum() / max(m.sum() * a.shape[-1], 1.0)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def main(argv: Optional[List[str]] = None) -> int:
    args = get_args(argv)
    os.makedirs(args.out, exist_ok=True)
    import torch

    from .. import convert
    from ..compose.inpainters import push_pull_inpaint
    from ..io import jpeg
    from ..models.diffusion import ControlNet, UNet2DCondition, UNetConfig
    from ..models.sd_pipeline import SDModels, make_sd_inpaint_fn
    from ..models.vae import AutoencoderKL
    from ..train.sd_inpaint_trainer import (create_train_state,
                                            init_weights,
                                            make_diffusion_train_step,
                                            make_vae_train_step,
                                            save_sd_checkpoint)
    from ..train.transref_trainer import draw_rect_boxes, rect_masks
    from ..utils.precision import fp32_exact

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {args.device}: no CUDA device "
                               "(pass --device cpu to train on the CPU)")
        torch.cuda.set_device(device)
        fp32_exact()

    w, S = args.width, args.size
    unet_kw = dict(in_channels=9, out_channels=4,
                   block_channels=(w, 2 * w), layers_per_block=1,
                   attention_resolutions=(0, 1), context_dim=2 * w,
                   num_heads=4, num_train_timesteps=1000, norm_groups=8)
    vae_kw = dict(block_channels=(w, w, 2 * w, 2 * w), latent_channels=4,
                  groups=8)
    cfg = UNetConfig(**unet_kw)
    g_init = torch.Generator().manual_seed(args.seed)
    unet, cnet, vae = (init_weights(m, g_init).to(device) for m in (
        UNet2DCondition(cfg), ControlNet(cfg), AutoencoderKL(**vae_kw)))

    rng = np.random.default_rng(args.seed)
    g_holes = torch.Generator().manual_seed(args.seed + 1)
    train_imgs = make_crops(S, args.n_train, rng)
    eval_imgs = make_crops(S, args.n_eval, rng)          # held-out crops
    train_holes = rect_masks(*draw_rect_boxes(g_holes, args.n_train, S),
                             S).numpy()
    eval_holes = rect_masks(*draw_rect_boxes(g_holes, args.n_eval, S),
                            S).numpy()
    # the empty-prompt CLIP context is a constant; a fixed random context
    # plays its role and ships inside the checkpoint
    context = torch.randn((1, 77, unet_kw["context_dim"]),
                          generator=torch.Generator().manual_seed(
                              args.seed + 2)).to(device)
    n_par = sum(p.numel() for m in (vae, unet, cnet)
                for p in m.parameters())
    print(f"params: {n_par / 1e6:.2f} M (vae+unet+controlnet)", flush=True)

    if args.init_ckpt:
        blob = convert.load_sd_container(args.init_ckpt)
        if blob.get("format") != "stitchax_jax":
            raise ValueError(f"--init_ckpt {args.init_ckpt}: not a "
                             "stitchax_jax container")
        for m, key in ((unet, "unet_vars"), (cnet, "controlnet_vars"),
                       (vae, "vae_vars")):
            convert.load_jax_params(m, blob[key])
        context = torch.as_tensor(blob["context"],
                                  dtype=torch.float32).to(device)
        print(f"resumed from {args.init_ckpt}", flush=True)
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)

    # ---------------- phase 1: VAE autoencoder ----------------
    vae_state, tx_v = create_train_state({"vae": vae}, args.lr_vae)
    vstep = make_vae_train_step(vae, tx_v)
    t_start = time.time()
    for step in range(1, args.steps_vae + 1):
        sel = rng.integers(0, args.n_train, args.batch)
        vae_state, vm = vstep(vae_state, dev(train_imgs[sel] / 127.5 - 1.0))
        if step % 250 == 0 or step == args.steps_vae:
            print(f"[vae {step}] l1={float(vm['l1']):.4f} "
                  f"l2={float(vm['l2']):.4f}", flush=True)
    del vae_state
    vae.requires_grad_(False)
    with torch.no_grad():
        recon = vae(dev(eval_imgs / 127.5 - 1.0).permute(0, 3, 1, 2))
    recon = recon.permute(0, 2, 3, 1).cpu().numpy()
    vae_psnr = hole_psnr255((recon + 1) * 127.5, eval_imgs,
                            np.ones_like(eval_holes))
    print(f"VAE recon PSNR (held-out): {vae_psnr:.2f} dB "
          f"({time.time() - t_start:.0f}s)", flush=True)

    # ---------------- eval pipeline (shared by all arms) ----------------
    models = SDModels(unet, cnet, vae, context)

    def pipeline_outs(strength=1.0):
        fn = make_sd_inpaint_fn(models, num_steps=args.eval_ddim_steps,
                                seed=args.seed, strength=strength)
        return np.stack([fn(dev(eval_imgs[i]), dev(eval_holes[i])).cpu()
                         .numpy() for i in range(args.n_eval)])

    def pipeline_psnr(strength=1.0):
        return hole_psnr255(pipeline_outs(strength), eval_imgs, eval_holes)

    psnr_init = pipeline_psnr()
    pp_outs = np.stack([push_pull_inpaint(dev(eval_imgs[i]),
                                          dev(eval_holes[i])).cpu().numpy()
                        for i in range(args.n_eval)])
    psnr_pushpull = hole_psnr255(pp_outs, eval_imgs, eval_holes)
    init_label = "resumed-stack" if args.init_ckpt else "random-stack"
    print(f"[step 0] {init_label} hole PSNR {psnr_init:.2f}  "
          f"push-pull baseline {psnr_pushpull:.2f}", flush=True)

    # ---------------- phase 2: diffusion on holes ----------------
    state, tx = create_train_state({"unet": unet, "controlnet": cnet},
                                   args.lr)
    dstep = make_diffusion_train_step(unet, cnet, vae, tx, context)
    g_noise = torch.Generator(device=device).manual_seed(args.seed + 3)
    save = lambda name, strength: save_sd_checkpoint(
        os.path.join(args.out, name), unet, cnet, vae, context, unet_kw,
        vae_kw, preferred_strength=strength)
    losses, history = [], []
    best_refine = -1.0
    for step in range(1, args.steps + 1):
        sel = rng.integers(0, args.n_train, args.batch)
        state, dm = dstep(state, dev(train_imgs[sel] / 255.0),
                          dev(train_holes[sel]), g_noise)
        losses.append(float(dm["mse"]))
        if step % args.eval_every == 0 or step == args.steps:
            p = pipeline_psnr()
            pr = pipeline_psnr(args.eval_strength)
            history.append(dict(step=step, mse=losses[-1], hole_psnr=p,
                                hole_psnr_refine=pr))
            print(f"[step {step}] mse {losses[-1]:.4f}  "
                  f"hole PSNR {p:.2f}  refine(s={args.eval_strength}) "
                  f"{pr:.2f}", flush=True)
            if args.save_ckpt:
                # each snapshot records its measured-best operating point
                save("sd_ckpt.pt", args.eval_strength if pr > p else 1.0)
                if pr > best_refine:
                    best_refine = pr
                    save("sd_ckpt_best.pt", args.eval_strength)

    p_end = history[-1]["hole_psnr"]
    p_refine_best = max(h["hole_psnr_refine"] for h in history)
    first = float(np.mean(losses[:50]))
    last = float(np.mean(losses[-50:]))
    checks = {
        "diffusion_loss_decreases": last < 0.8 * first,
        # step 0 is the trained restored stack when --init_ckpt is given:
        # the random-pack margin applies only to runs from scratch
        "beats_random_pack": (p_end > psnr_init + 2.0
                              if not args.init_ckpt else None),
        "beats_push_pull_fallback": p_end > psnr_pushpull,
        "refine_beats_push_pull": p_refine_best > psnr_pushpull,
    }

    # before / after panel on the first eval image
    holed = eval_imgs[0] * (1 - eval_holes[0])
    out = pipeline_outs()[0]
    row = np.concatenate([holed, pp_outs[0], out, eval_imgs[0]], axis=1)
    jpeg.write(os.path.join(args.out, "panel_final.jpg"),
               np.clip(row, 0, 255).astype(np.uint8))

    result = dict(steps=args.steps, steps_vae=args.steps_vae, size=S,
                  width=w, batch=args.batch, lr=args.lr,
                  params_m=round(n_par / 1e6, 2),
                  vae_recon_psnr=round(vae_psnr, 2),
                  mse_first50=round(first, 4), mse_last50=round(last, 4),
                  psnr_step0=round(psnr_init, 2),
                  init_is_resumed=bool(args.init_ckpt),
                  psnr_push_pull=round(psnr_pushpull, 2),
                  psnr_trained=round(p_end, 2),
                  psnr_refine_best=round(p_refine_best, 2),
                  eval_strength=args.eval_strength,
                  eval_ddim_steps=args.eval_ddim_steps,
                  history=history, checks=checks,
                  cli=" ".join(["python -m stitchax_torch.train_sd_inpaint",
                                *(sys.argv[1:] if argv is None else argv)]))
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(checks))
    print(f"wrote {os.path.join(args.out, 'result.json')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
