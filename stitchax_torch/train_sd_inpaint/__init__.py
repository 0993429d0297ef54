"""stitchax_torch.train_sd_inpaint: the SD inpainting trainer's CLI (port of
tools/train_sd_inpaint_learns.py); `python -m
stitchax_torch.train_sd_inpaint` runs it."""
