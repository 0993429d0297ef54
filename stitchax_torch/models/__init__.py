"""The port's models: FlowFormer++ (twins encoders, cost perceiver, memory
decoder) and its MAE pretraining model, the UDIS2 homography and
composition nets, TransRef, and the VGG16 features of TransRef's training
loss."""

from .flowformer import FlowFormer, FlowFormerConfig, FlowFormerPretrain
from .transref import TransRefBase
from .udis2 import CompositionNet, UDIS2HomographyNet, compose_seam
from .vgg import VGG16Features

__all__ = ["CompositionNet", "FlowFormer", "FlowFormerConfig",
           "FlowFormerPretrain", "TransRefBase", "UDIS2HomographyNet", "VGG16Features",
           "compose_seam"]
