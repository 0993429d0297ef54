"""Per-pair stitching entry points."""

from .stitcher import Stitcher, StitchModels

__all__ = ["Stitcher", "StitchModels"]
