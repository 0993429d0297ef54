"""Datasets and loaders of the port (port of stitchax/data): the UDIS-D
loader, the optical-flow file formats, the flow-pretraining datasets and
their augmentation, and the flow colour wheel."""

from .flow_viz import flow_to_image
from .frame_utils import read_flo, read_gen, read_pfm, write_flo, write_pfm
from .udis import PrefetchLoader, UDISDataset, fetch_dataloader

__all__ = ["UDISDataset", "PrefetchLoader", "fetch_dataloader",
           "read_flo", "write_flo", "read_pfm", "write_pfm", "read_gen",
           "flow_to_image"]
