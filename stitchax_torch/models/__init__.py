"""The port's models: FlowFormer++ (twins encoders, cost perceiver, memory
decoder), the UDIS2 homography and composition nets, and TransRef."""

from .flowformer import FlowFormer, FlowFormerConfig
from .transref import TransRefBase
from .udis2 import CompositionNet, UDIS2HomographyNet, compose_seam

__all__ = ["CompositionNet", "FlowFormer", "FlowFormerConfig",
           "TransRefBase", "UDIS2HomographyNet", "compose_seam"]
