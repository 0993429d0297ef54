"""stitchax_torch.train_transref: the TransRef trainer's CLI (port of
train_transref.py); `python -m stitchax_torch.train_transref` runs it."""
