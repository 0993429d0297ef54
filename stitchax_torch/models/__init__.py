"""The port's models: FlowFormer++ (twins encoders, cost perceiver, memory
decoder) and the UDIS2 homography net."""

from .flowformer import FlowFormer, FlowFormerConfig
from .udis2 import UDIS2HomographyNet

__all__ = ["FlowFormer", "FlowFormerConfig", "UDIS2HomographyNet"]
