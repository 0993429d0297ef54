"""stitchax_torch.train: the alignment trainer (port of stitchax/train/).

`python -m stitchax_torch.train` runs it (train.py's flags; one card, or
one rank a card under torch.distributed.run).
`transref_trainer` is the TransRef trainer's step (train_transref.py's,
run by `python -m stitchax_torch.train_transref`), `sd_inpaint_trainer`
the SD inpainting stack's VAE and diffusion steps (run by `python -m
stitchax_torch.train_sd_inpaint`).
"""

from .losses import (LossConfig, border_zero_flow_loss, photometric_l1,
                     rigid_motion_loss, sequence_alignment_loss,
                     smoothness_loss)
from .optim import (OptimConfig, OptState, Optimizer, apply_updates,
                    fetch_optimizer, onecycle_schedule)
from .trainer import (TrainState, align_train_forward, create_train_state,
                      make_train_step, occlusion_mask, restore_checkpoint,
                      save_checkpoint, stitchax_tree)

__all__ = [k for k in dir() if not k.startswith("_")]
