"""UDIS-D splits and a threaded prefetching loader (port of
stitchax/data/udis.py).

Layout: {data_dir}/{phase}/input1/*.jpg paired with input2/*.jpg by file
name. Each item holds image1, image2 (float32 HWC in [0, 255], read with
the port's JPEG decoder and, with `size`, resized as Pillow's BILINEAR
does: the same pixels stitchax's loader reads through Pillow) and name;
a training item also the zero `flow` and the ones `valid` (UDIS-D has no
ground-truth flow) and, with `return_depth`, `depth2`, the channel mean of
{phase}/depth2/<name>. The loader shuffles each epoch with
`np.random.default_rng(seed + epoch)`, epochs counted from 1, as
stitchax's does, so both give the same pairs in the same order.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Queue
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..io import jpeg
from ..io.resize import resize_bilinear


class UDISDataset:
    def __init__(self, data_dir: str, phase: str = "training",
                 is_test: Optional[bool] = None,
                 size: Optional[Tuple[int, int]] = None,
                 return_depth: bool = False,
                 clip_num_data: Optional[int] = None):
        self.size = size
        self.is_test = (phase == "testing") if is_test is None else is_test
        self.return_depth = return_depth
        root = os.path.join(data_dir, phase)
        d1, d2 = os.path.join(root, "input1"), os.path.join(root, "input2")
        self.depth_dir = os.path.join(root, "depth2")
        if not os.path.isdir(d1):
            raise FileNotFoundError(f"no such dataset split: {d1}")
        if return_depth and not os.path.isdir(self.depth_dir):
            raise FileNotFoundError(f"return_depth=True but no depth2 "
                                    f"directory at {self.depth_dir}")
        self.pairs: List[Tuple[str, str, str]] = [
            (os.path.join(d1, n), os.path.join(d2, n), n)
            for n in sorted(os.listdir(d1))
            if os.path.exists(os.path.join(d2, n))
            and (not return_depth
                 or os.path.exists(os.path.join(self.depth_dir, n)))]
        if clip_num_data is not None:
            self.pairs = self.pairs[:clip_num_data]

    def __len__(self):
        return len(self.pairs)

    def _load(self, path: str) -> np.ndarray:
        img = jpeg.read_rgb(path)
        if self.size is not None:
            img = resize_bilinear(img, self.size[0], self.size[1])
        return img.astype(np.float32)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        p1, p2, name = self.pairs[idx]
        img1 = self._load(p1)
        item = {"image1": img1, "image2": self._load(p2), "name": name}
        if not self.is_test:
            h, w = img1.shape[:2]
            item["flow"] = np.zeros((h, w, 2), np.float32)
            item["valid"] = np.ones((h, w), np.float32)
            if self.return_depth:
                item["depth2"] = self._load(os.path.join(
                    self.depth_dir, name)).mean(-1, keepdims=True)
        return item


class PrefetchLoader:
    """Batches of a dataset, in order or shuffled per epoch, read by a
    thread pool while the previous batches are consumed. A failed read
    raises in the consumer. `prefetch` batches are read ahead. `skip(n)`
    fast-forwards past the first n batches of the coming epochs without
    reading them."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 8, seed: int = 0,
                 drop_last: bool = False, prefetch: int = 2):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._epoch = 0
        self._skip = 0

    def __len__(self):
        n = len(self.ds)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _batch_indices(self) -> List[List[int]]:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        batches = [idx[i:i + self.batch_size].tolist()
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def skip(self, n: int) -> None:
        """Start where a run that took n batches from a fresh loader stands:
        whole epochs are counted, the rest is dropped from the next."""
        per_epoch = len(self)
        if per_epoch:
            self._epoch += n // per_epoch
            self._skip = n % per_epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._epoch += 1
        batches = self._batch_indices()[self._skip:]
        self._skip = 0
        q: Queue = Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce(pool):
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    q.put(self._collate(list(pool.map(self.ds.__getitem__,
                                                      b))))
            except Exception as e:  # noqa: BLE001 -- re-raised by the consumer
                q.put(e)
                return
            q.put(None)

        with ThreadPoolExecutor(self.num_workers) as pool:
            t = threading.Thread(target=produce, args=(pool,), daemon=True)
            t.start()
            try:
                while True:
                    batch = q.get()
                    if batch is None:
                        break
                    if isinstance(batch, Exception):
                        raise batch
                    yield batch
            finally:
                stop.set()
                while t.is_alive():         # unblock a producer in put()
                    try:
                        q.get_nowait()
                    except Empty:
                        pass
                    t.join(0.01)

    @staticmethod
    def _collate(items: List[Dict]) -> Dict[str, np.ndarray]:
        out = {}
        for k in items[0]:
            vals = [it[k] for it in items]
            out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) \
                else vals
        return out


def fetch_dataloader(cfg, phase: str = "training") -> PrefetchLoader:
    """The 'udis' stage: `cfg.udis_dataset` (data_dir, return_depth,
    clip_num_data) at `cfg.image_size`, batch `cfg.batch_size`; training
    shuffles (seed 0) and drops the last partial batch."""
    ds_cfg = cfg.get("udis_dataset", {}) if hasattr(cfg, "get") else {}
    ds = UDISDataset(ds_cfg.get("data_dir", "./UDIS-D/"), phase=phase,
                     size=tuple(cfg.get("image_size", [512, 512])),
                     return_depth=bool(ds_cfg.get("return_depth", False)),
                     clip_num_data=ds_cfg.get("clip_num_data"))
    return PrefetchLoader(ds, batch_size=cfg.get("batch_size", 1),
                          shuffle=(phase == "training"), num_workers=8,
                          drop_last=(phase == "training"))
