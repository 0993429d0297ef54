"""The port's flow-pretraining data (stitchax_torch.data.frame_utils,
augmentor, flow_datasets; io.png, io.raster, io.enhance and the float
resize) against stitchax's and Pillow, on the CPU.

Every check is bit-equal: the port decodes and augments without Pillow, in
numpy, with Pillow's integer and float arithmetic, so its arrays are the
ones stitchax gets through Pillow. The images are small seeded ones the
tests write.
"""

import os

import numpy as np
import pytest
from PIL import Image, ImageEnhance

from stitchax.data import augmentor as jaug
from stitchax.data import flow_datasets as jds
from stitchax.data import frame_utils as jfu
from stitchax_torch.data import augmentor as taug
from stitchax_torch.data import flow_datasets as tds
from stitchax_torch.data import frame_utils as tfu
from stitchax_torch.io import enhance, png, raster
from stitchax_torch.io.resize import resize_bilinear_float


def smooth(rng, h, w, c=3):
    """A blocky uint8 image with a little noise: the PNG filters all get
    used on it."""
    base = rng.integers(0, 250, (h // 4 + 2, w // 4 + 2, c))
    img = np.kron(base, np.ones((4, 4, 1)))[:h, :w]
    return (img + rng.integers(0, 5, (h, w, c))).astype(np.uint8)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --------------------------------- file IO -----------------------------------

def test_flo_and_pfm_round_trip_between_packages(rng, tmp_path):
    flow = rng.normal(0, 20, (13, 17, 2)).astype(np.float32)
    for write, read in ((tfu.write_flo, jfu.read_flo),
                        (jfu.write_flo, tfu.read_flo)):
        write(str(tmp_path / "a.flo"), flow)
        _same(read(str(tmp_path / "a.flo")), flow)
    for img in (flow[..., 0].copy(),
                rng.normal(0, 5, (9, 11, 3)).astype(np.float32)):
        for write, read in ((tfu.write_pfm, jfu.read_pfm),
                            (jfu.write_pfm, tfu.read_pfm)):
            write(str(tmp_path / "a.pfm"), img)
            _same(read(str(tmp_path / "a.pfm")), img)
    tfu.write_pfm(str(tmp_path / "b.pfm"), rng.normal(
        0, 5, (9, 11, 3)).astype(np.float32))
    _same(tfu.read_gen(str(tmp_path / "b.pfm")),
          jfu.read_gen(str(tmp_path / "b.pfm")))


PNG_MODES = ["RGB", "RGBA", "L", "LA", "P2", "P4", "P16", "P256", "1",
             "I;16", "RGB16", "RGBA16", "LA16"]


def _png(rng, path, mode):
    """A PNG of `mode`: Pillow writes the 8-bit, palette and 16-bit gray
    ones (with its adaptive filters), the 16-bit colour ones are written
    here (Pillow cannot), unfiltered."""
    import struct
    import zlib

    h, w = 11, 19
    if mode in ("RGB16", "RGBA16", "LA16"):
        ch = {"RGB16": 3, "RGBA16": 4, "LA16": 2}[mode]
        ctype = {"RGB16": 2, "RGBA16": 6, "LA16": 4}[mode]
        a = rng.integers(0, 1 << 16, (h, w, ch)).astype(">u2")
        rows = a.reshape(h, -1).view(np.uint8)
        raw = b"".join(bytes([0]) + rows[i].tobytes() for i in range(h))

        def chunk(t, d):
            return (struct.pack(">I", len(d)) + t + d
                    + struct.pack(">I", zlib.crc32(t + d) & 0xFFFFFFFF))
        with open(path, "wb") as f:
            f.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(
                ">IIBBBBB", w, h, 16, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
        return
    a = smooth(rng, h, w, 4)
    if mode in ("RGB", "RGBA", "LA"):
        im = Image.fromarray(a[..., :len(mode)].copy(), mode)
    elif mode == "L":
        im = Image.fromarray(a[..., 0].copy())
    elif mode.startswith("P"):
        im = Image.fromarray(a[..., :3].copy()).convert(
            "P", palette=Image.ADAPTIVE, colors=int(mode[1:]))
    elif mode == "1":
        im = Image.fromarray(a[..., 0].copy()).convert("1")
    else:
        im = Image.fromarray(rng.integers(0, 600, (h, w)).astype(np.uint16))
    im.save(path)


@pytest.mark.parametrize("mode", PNG_MODES)
def test_png_decoder_equals_pillow(rng, tmp_path, mode):
    path = str(tmp_path / "a.png")
    _png(rng, path, mode)
    _same(png.read(path), np.asarray(Image.open(path)))
    _same(raster.read_rgb(path), np.asarray(Image.open(path).convert("RGB")))


def test_png_filters_decode_as_pillow(rng, tmp_path):
    """Rows filtered with each of the five filter types (written here,
    one type a row, 8- and 16-bit)."""
    import struct
    import zlib

    for depth, ch in ((8, 3), (16, 3)):
        h, w = 10, 13
        dt = np.uint8 if depth == 8 else ">u2"
        a = rng.integers(0, 1 << depth, (h, w, ch)).astype(dt)
        rows = a.reshape(h, -1).view(np.uint8).astype(np.int64)
        bpp = ch * depth // 8
        raw = b""
        prior = np.zeros(rows.shape[1], np.int64)
        for y in range(h):
            kind, cur = y % 5, rows[y]
            left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
            ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
            if kind == 0:
                f = cur
            elif kind == 1:
                f = cur - left
            elif kind == 2:
                f = cur - prior
            elif kind == 3:
                f = cur - (left + prior) // 2
            else:
                p = left + prior - ul
                pa, pb, pc = abs(p - left), abs(p - prior), abs(p - ul)
                pred = np.where((pa <= pb) & (pa <= pc), left,
                                np.where(pb <= pc, prior, ul))
                f = cur - pred
            raw += bytes([kind]) + (f & 0xFF).astype(np.uint8).tobytes()
            prior = cur

        def chunk(t, d):
            return (struct.pack(">I", len(d)) + t + d
                    + struct.pack(">I", zlib.crc32(t + d) & 0xFFFFFFFF))
        path = str(tmp_path / f"f{depth}.png")
        with open(path, "wb") as fh:
            fh.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(
                ">IIBBBBB", w, h, depth, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
        _same(png.read(path), np.asarray(Image.open(path)))


@pytest.mark.parametrize("ext", ["ppm", "pgm", "bmp", "bmp32", "jpg"])
def test_raster_readers_equal_pillow(rng, tmp_path, ext):
    a = smooth(rng, 17, 23, 4)
    if ext == "pgm":
        im = Image.fromarray(a[..., 0].copy())
    elif ext == "bmp32":
        im = Image.fromarray(a, "RGBA")
    else:
        im = Image.fromarray(a[..., :3].copy())
    path = str(tmp_path / ("a." + ext[:3]))
    im.save(path)
    _same(raster.read_rgb(path), np.asarray(Image.open(path).convert("RGB")))
    if ext != "pgm":
        _same(tfu.read_gen(path), jfu.read_gen(path))


def test_kitti_png_flow_reads_as_stitchax(rng, tmp_path):
    path = str(tmp_path / "k.png")
    _png(rng, path, "RGB16")
    (tf, tv), (jf, jv) = (tfu.read_kitti_png_flow(path),
                          jfu.read_kitti_png_flow(path))
    _same(tf, jf)
    _same(tv, jv)


# ------------------------------ Pillow's arithmetic --------------------------

def test_image_enhance_equals_pillow(rng):
    for _ in range(40):
        h, w = rng.integers(1, 30, 2)
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        pil = Image.fromarray(img)
        for factor in (float(rng.uniform(0.0, 1.0)),
                       float(rng.uniform(1.0, 2.0))):
            for name, fn in (("Brightness", enhance.brightness),
                             ("Contrast", enhance.contrast),
                             ("Color", enhance.color)):
                want = np.asarray(getattr(ImageEnhance, name)(pil).enhance(
                    factor))
                _same(fn(img, factor), want)


def test_float_resize_equals_pillow(rng):
    for _ in range(40):
        h, w = (int(x) for x in rng.integers(1, 50, 2))
        nh, nw = (int(x) for x in rng.integers(1, 80, 2))
        a = rng.normal(0, 30, (h, w)).astype(np.float32)
        want = np.asarray(Image.fromarray(a).resize((nw, nh),
                                                    Image.BILINEAR))
        _same(resize_bilinear_float(a, nh, nw), want)


# ------------------------------- augmentation --------------------------------

def _flow_pair(rng, h=60, w=90):
    return (smooth(rng, h, w).astype(np.float32),
            smooth(rng, h, w).astype(np.float32),
            rng.normal(0, 8, (h, w, 2)).astype(np.float32))


@pytest.mark.parametrize("seed", range(6))
def test_flow_augmentor_equals_stitchax(rng, seed):
    """Six seeds: the symmetric and asymmetric jitter, the eraser, the
    stretch, the flips and the crop all come up."""
    img1, img2, flow = _flow_pair(rng)
    cfg = dict(crop_size=(40, 56), asymmetric_color_aug_prob=0.5)
    got = taug.FlowAugmentor(taug.AugmentorConfig(**cfg), seed=seed)(
        img1.copy(), img2.copy(), flow.copy())
    want = jaug.FlowAugmentor(jaug.AugmentorConfig(**cfg), seed=seed)(
        img1.copy(), img2.copy(), flow.copy())
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("seed", range(4))
def test_sparse_flow_augmentor_equals_stitchax(rng, seed):
    img1, img2, flow = _flow_pair(rng, 36, 100)
    valid = (rng.random((36, 100)) < 0.4).astype(np.float32)
    cfg = dict(crop_size=(40, 64))       # taller than the input: padded
    got = taug.SparseFlowAugmentor(taug.AugmentorConfig(**cfg), seed=seed)(
        img1.copy(), img2.copy(), flow.copy(), valid.copy())
    want = jaug.SparseFlowAugmentor(jaug.AugmentorConfig(**cfg), seed=seed)(
        img1.copy(), img2.copy(), flow.copy(), valid.copy())
    for g, w in zip(got, want):
        _same(g, w)


def test_chromatic_and_pca_lighting_equal_stitchax(rng):
    img1, img2, _ = _flow_pair(rng)
    for g, w in zip(taug.chromatic_transform(np.random.default_rng(3), img1,
                                             img2),
                    jaug.chromatic_transform(np.random.default_rng(3), img1,
                                             img2)):
        _same(g, w)
    _same(taug.pca_lighting(np.random.default_rng(4), img1),
          jaug.pca_lighting(np.random.default_rng(4), img1))


# --------------------------------- datasets ----------------------------------

def _tree(rng, root):
    """A synthetic tree of every dataset layout, two or three samples
    each, 40 x 60."""
    h, w = 40, 60

    def img(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(smooth(rng, h, w)).save(path)

    def flo(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        jfu.write_flo(path, rng.normal(0, 5, (h, w, 2)).astype(np.float32))

    def kitti(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _png(rng, path, "RGB16")

    chairs = os.path.join(root, "chairs")
    for i in range(2):
        img(os.path.join(chairs, f"{i:05d}_img1.ppm"))
        img(os.path.join(chairs, f"{i:05d}_img2.ppm"))
        flo(os.path.join(chairs, f"{i:05d}_flow.flo"))
    things = os.path.join(root, "things")
    for i in range(3):
        img(os.path.join(things, "frames_cleanpass/TRAIN/A/0000/left",
                         f"{i:04d}.png"))
        for d in ("into_future", "into_past"):
            path = os.path.join(things, "optical_flow/TRAIN/A/0000", d,
                                "left", f"{i:04d}.pfm")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            jfu.write_pfm(path, rng.normal(0, 5, (h, w, 3)).astype(
                np.float32))
    sintel = os.path.join(root, "sintel")
    for i in range(3):
        img(os.path.join(sintel, "training/clean/alley", f"{i:04d}.png"))
        if i < 2:
            flo(os.path.join(sintel, "training/flow/alley", f"{i:04d}.flo"))
    kitti_root = os.path.join(root, "kitti")
    for i in range(2):
        for t in ("10", "11"):
            img(os.path.join(kitti_root, "training/image_2",
                             f"{i:06d}_{t}.png"))
        kitti(os.path.join(kitti_root, "training/flow_occ",
                           f"{i:06d}_10.png"))
    hd1k = os.path.join(root, "hd1k")
    for i in range(3):
        img(os.path.join(hd1k, "hd1k_input/image_2", f"000000_{i:04d}.png"))
        kitti(os.path.join(hd1k, "hd1k_flow_gt/flow_occ",
                           f"000000_{i:04d}.png"))
    ca = os.path.join(root, "ca")
    for i in range(2):
        img(os.path.join(ca, "img", f"a{i}.jpg"))
        img(os.path.join(ca, "img", f"b{i}.jpg"))
    with open(os.path.join(ca, "train.txt"), "w") as f:
        f.write("a0.jpg b0.jpg\na1.jpg b1.jpg\n")
    return {"chairs": chairs, "things": things, "sintel": sintel,
            "kitti": kitti_root, "hd1k": hd1k, "ca": ca}


AUG = dict(crop_size=(32, 48), min_scale=-0.1, max_scale=0.3)


@pytest.mark.parametrize("name", ["FlyingChairs", "FlyingThings3D",
                                  "MpiSintel", "KITTI", "HD1K", "CADataset"])
def test_dataset_samples_equal_stitchax(rng, tmp_path, name):
    """Each dataset class over the synthetic tree: the same lists and,
    item by item, the same arrays, with and without augmentation."""
    roots = _tree(rng, str(tmp_path))
    kw = {"FlyingChairs": dict(root=roots["chairs"]),
          "FlyingThings3D": dict(root=roots["things"]),
          "MpiSintel": dict(root=roots["sintel"]),
          "KITTI": dict(root=roots["kitti"]),
          "HD1K": dict(root=roots["hd1k"]),
          "CADataset": dict(data_dir=roots["ca"])}[name]
    for aug in (None, AUG):
        t = getattr(tds, name)(aug_params=aug, **kw)
        j = getattr(jds, name)(aug_params=aug, **kw)
        assert len(t) == len(j) > 0
        assert t.image_list == j.image_list and t.flow_list == j.flow_list
        for i in range(len(t)):
            got, want = t[i], j[i]
            assert sorted(got) == sorted(want)
            for k in want:
                _same(got[k], want[k])
