"""Optical-flow pretraining datasets: Chairs, Things, Sintel, KITTI, HD1K
and the cross-attention pretraining pairs (port of
stitchax/data/flow_datasets.py).

Each dataset lists (img1, img2, flow) triples on disk and loads them
lazily through the port's decoders (`frame_utils`); augmentation is the
numpy FlowAugmentor. The same files and seed give stitchax's samples.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np

from .augmentor import AugmentorConfig, FlowAugmentor, SparseFlowAugmentor
from .frame_utils import read_gen, read_kitti_png_flow


class FlowDataset:
    """Base: index lists + loading + optional augmentation
    (reference: core/datasets.py:13-95)."""

    def __init__(self, aug_params: Optional[dict] = None,
                 sparse: bool = False):
        self.sparse = sparse
        self.augmentor = None
        if aug_params is not None:
            cls = SparseFlowAugmentor if sparse else FlowAugmentor
            self.augmentor = cls(AugmentorConfig(**aug_params))
        self.flow_list: List[str] = []
        self.image_list: List[Tuple[str, str]] = []
        self.extra_info: List = []

    def __len__(self):
        return len(self.image_list)

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        p1, p2 = self.image_list[idx]
        img1 = np.asarray(read_gen(p1), np.float32)[..., :3]
        img2 = np.asarray(read_gen(p2), np.float32)[..., :3]

        valid = None
        if self.sparse:
            flow, valid = read_kitti_png_flow(self.flow_list[idx])
        else:
            flow = read_gen(self.flow_list[idx]).astype(np.float32)

        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(img1, img2, flow,
                                                         valid)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow)
        if valid is None:
            valid = ((np.abs(flow[..., 0]) < 1000)
                     & (np.abs(flow[..., 1]) < 1000))
        return {"image1": img1, "image2": img2,
                "flow": flow.astype(np.float32),
                "valid": valid.astype(np.float32)}


class FlyingChairs(FlowDataset):
    def __init__(self, aug_params=None, split="training",
                 root="datasets/FlyingChairs_release/data",
                 split_file: Optional[str] = None):
        super().__init__(aug_params)
        images = sorted(glob(os.path.join(root, "*.ppm")))
        flows = sorted(glob(os.path.join(root, "*.flo")))
        assert len(images) // 2 == len(flows)
        split_list = None
        if split_file and os.path.exists(split_file):
            split_list = np.loadtxt(split_file, dtype=np.int32)
        for i in range(len(flows)):
            xid = split_list[i] if split_list is not None else (
                1 if split == "training" else 2)
            # chairs_split.txt marks training samples with 1, validation
            # with 2 (reference: core/datasets.py:146-149)
            keep = (split == "training" and xid == 1) or (
                split == "validation" and xid == 2)
            if not keep:
                continue
            self.flow_list.append(flows[i])
            self.image_list.append((images[2 * i], images[2 * i + 1]))


class FlyingThings3D(FlowDataset):
    def __init__(self, aug_params=None, root="datasets/FlyingThings3D",
                 dstype="frames_cleanpass"):
        super().__init__(aug_params)
        for cam in ("left",):
            for direction in ("into_future", "into_past"):
                idirs = sorted(glob(os.path.join(root, dstype, "TRAIN/*/*")))
                fdirs = sorted(glob(os.path.join(
                    root, "optical_flow/TRAIN/*/*")))
                for idir, fdir in zip(idirs, fdirs):
                    images = sorted(glob(os.path.join(idir, cam, "*.png")))
                    flows = sorted(glob(os.path.join(fdir, direction, cam,
                                                     "*.pfm")))
                    if direction == "into_future":
                        pairs = zip(images[:-1], images[1:], flows[:-1])
                    else:
                        pairs = zip(images[1:], images[:-1], flows[1:])
                    for i1, i2, fl in pairs:
                        self.image_list.append((i1, i2))
                        self.flow_list.append(fl)


class MpiSintel(FlowDataset):
    def __init__(self, aug_params=None, split="training",
                 root="datasets/Sintel", dstype="clean"):
        super().__init__(aug_params)
        image_root = os.path.join(root, split, dstype)
        flow_root = os.path.join(root, split, "flow")
        for scene in sorted(os.listdir(image_root)) if os.path.isdir(
                image_root) else []:
            images = sorted(glob(os.path.join(image_root, scene, "*.png")))
            for i in range(len(images) - 1):
                self.image_list.append((images[i], images[i + 1]))
                self.extra_info.append((scene, i))
            if split != "test":
                self.flow_list += sorted(glob(os.path.join(flow_root, scene,
                                                           "*.flo")))


class KITTI(FlowDataset):
    def __init__(self, aug_params=None, split="training",
                 root="datasets/KITTI"):
        super().__init__(aug_params, sparse=True)
        root = os.path.join(root, split)
        images1 = sorted(glob(os.path.join(root, "image_2/*_10.png")))
        images2 = sorted(glob(os.path.join(root, "image_2/*_11.png")))
        for i1, i2 in zip(images1, images2):
            self.image_list.append((i1, i2))
            self.extra_info.append([os.path.basename(i1)])
        if split == "training":
            self.flow_list = sorted(glob(os.path.join(root,
                                                      "flow_occ/*_10.png")))


class HD1K(FlowDataset):
    def __init__(self, aug_params=None, root="datasets/HD1k"):
        super().__init__(aug_params, sparse=True)
        seq_ix = 0
        while True:
            flows = sorted(glob(os.path.join(
                root, f"hd1k_flow_gt/flow_occ/{seq_ix:06d}_*.png")))
            images = sorted(glob(os.path.join(
                root, f"hd1k_input/image_2/{seq_ix:06d}_*.png")))
            if not flows:
                break
            for i in range(len(flows) - 1):
                self.flow_list.append(flows[i])
                self.image_list.append((images[i], images[i + 1]))
            seq_ix += 1


class CADataset(FlowDataset):
    """Cross-attention pretraining pairs listed in {phase}.txt with images
    under img/ — zero GT flow like UDIS (reference: core/datasets.py:243-325).
    """

    def __init__(self, data_dir, aug_params=None, phase: str = "train"):
        super().__init__(aug_params)
        assert phase in ("train", "val", "test")
        self.is_test = phase == "test"
        list_path = os.path.join(data_dir, f"{phase}.txt")
        with open(list_path) as f:
            for line in f:
                names = line.strip().split(" ")
                if len(names) < 2:
                    continue
                self.image_list.append(
                    (os.path.join(data_dir, "img", names[0]),
                     os.path.join(data_dir, "img", names[1])))
                self.extra_info.append(tuple(names[:2]))
        # zero-flow supervision: reuse FlowDataset loading with fake flow
        self.flow_list = [None] * len(self.image_list)

    def __getitem__(self, idx):
        p1, p2 = self.image_list[idx]
        img1 = np.asarray(read_gen(p1), np.float32)[..., :3]
        img2 = np.asarray(read_gen(p2), np.float32)[..., :3]
        flow = np.zeros(img1.shape[:2] + (2,), np.float32)
        if self.augmentor is not None and not self.is_test:
            img1, img2, flow = self.augmentor(img1, img2, flow)
        return {"image1": img1, "image2": img2,
                "flow": np.zeros(img1.shape[:2] + (2,), np.float32),
                "valid": np.ones(img1.shape[:2], np.float32)}
