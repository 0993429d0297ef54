"""UDIS-D test split and a threaded prefetching loader (port of
stitchax/data/udis.py, the testing phase).

Layout: {data_dir}/{phase}/input1/*.jpg paired with input2/*.jpg by file
name. Each item is (image1, image2, name), float32 HWC in [0, 255], read
with the port's JPEG decoder and, with `size`, resized as Pillow's
BILINEAR does: the same pixels stitchax's loader reads through Pillow.
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
    def __init__(self, data_dir: str, phase: str = "testing",
                 size: Optional[Tuple[int, int]] = None):
        self.size = size
        root = os.path.join(data_dir, phase)
        d1, d2 = os.path.join(root, "input1"), os.path.join(root, "input2")
        if not os.path.isdir(d1):
            raise FileNotFoundError(f"no such dataset split: {d1}")
        self.pairs: List[Tuple[str, str, str]] = [
            (os.path.join(d1, n), os.path.join(d2, n), n)
            for n in sorted(os.listdir(d1))
            if os.path.exists(os.path.join(d2, n))]

    def __len__(self):
        return len(self.pairs)

    def _load(self, path: str) -> np.ndarray:
        img = jpeg.read_rgb(path)
        if self.size is not None:
            img = resize_bilinear(img, self.size[0], self.size[1])
        return img.astype(np.float32)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        p1, p2, name = self.pairs[idx]
        return {"image1": self._load(p1), "image2": self._load(p2),
                "name": name}


class PrefetchLoader:
    """Batches of a dataset in order, read by a thread pool while the
    previous batches are consumed. A failed read raises in the consumer."""

    PREFETCH = 2        # batches read ahead

    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 8):
        self.ds = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers

    def __len__(self):
        return -(-len(self.ds) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = list(range(len(self.ds)))
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        q: Queue = Queue(maxsize=self.PREFETCH)
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
