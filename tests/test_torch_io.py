"""The port's image I/O (`stitchax_torch.io`) against Pillow, which
stitchax reads and writes every image with.

The decoder must give Pillow's pixels exactly (libjpeg-turbo's islow IDCT,
fancy upsampling and integer colour tables), the encoder Pillow's bytes
exactly (quality 75, 4:2:0, standard tables), and the BILINEAR resize
Pillow's pixels exactly.
"""

import glob
import io
import os

import numpy as np
import pytest
from PIL import Image

from stitchax_torch.io import jpeg
from stitchax_torch.io.resize import resize_bilinear

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
COMMITTED = sorted(
    glob.glob(os.path.join(REPO, "demo_data", "*", "*.jpg"))
    + glob.glob(os.path.join(REPO, "demo_scenes", "*", "*.jpg"))
    + glob.glob(os.path.join(REPO, "results", "*", "*.jpg"))
    + glob.glob(os.path.join(REPO, "results", "*", "*", "*.jpg"))
    + glob.glob(os.path.join(REPO, "tests", "torch_reference", "udis_synth",
                             "testing", "*", "*.jpg")))


def _image(shape, seed=0):
    """Smooth structure plus noise: both flat and busy blocks."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 90 * np.sin(xx / 7.0 + yy / 11.0)
    if len(shape) == 3:
        base = np.stack([base, np.roll(base, 5, 1), 255 - base], -1)
    noisy = base + rng.normal(0, 25, shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


def _pillow_bytes(a, **kw):
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pillow_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("path", [os.path.relpath(p, REPO)
                                  for p in COMMITTED])
def test_decoder_equals_pillow_on_committed_jpegs(path):
    data = open(os.path.join(REPO, path), "rb").read()
    np.testing.assert_array_equal(jpeg.decode(data), _pillow_decode(data))


CASES = [(shape, mode, q) for shape in ((37, 53), (64, 64), (17, 9), (1, 1),
                                        (100, 203))
         for mode in ("RGB", "L") for q in (50, 75, 95)]


@pytest.mark.parametrize("shape,mode,quality", CASES)
def test_decoder_equals_pillow_on_random_images(shape, mode, quality):
    a = _image(shape + ((3,) if mode == "RGB" else ()), seed=sum(shape))
    data = _pillow_bytes(a, quality=quality)
    np.testing.assert_array_equal(jpeg.decode(data), _pillow_decode(data))


@pytest.mark.parametrize("mode,kw", [
    ("RGB", dict(restart_marker_blocks=3)), ("RGB", dict(restart_marker_rows=1)),
    ("L", dict(restart_marker_blocks=3)), ("L", dict(restart_marker_rows=1)),
    ("RGB", dict(subsampling=0)),
    ("RGB", dict(subsampling=0, restart_marker_blocks=5))])
def test_decoder_restart_markers_and_444(mode, kw):
    a = _image((45, 77) + ((3,) if mode == "RGB" else ()), seed=3)
    data = _pillow_bytes(a, quality=85, **kw)
    np.testing.assert_array_equal(jpeg.decode(data), _pillow_decode(data))


def test_decoder_rejects_progressive():
    data = _pillow_bytes(_image((32, 32, 3)), progressive=True)
    with pytest.raises(NotImplementedError):
        jpeg.decode(data)


@pytest.mark.parametrize("shape,mode,quality", CASES)
def test_encoder_writes_pillows_bytes(shape, mode, quality):
    """The encoder's file is byte for byte Pillow's for the same array
    (so it also decodes, by Pillow, to Pillow's own file's pixels)."""
    a = _image(shape + ((3,) if mode == "RGB" else ()), seed=sum(shape) + 1)
    ours = jpeg.encode(a, quality)
    theirs = _pillow_bytes(a, quality=quality)
    np.testing.assert_array_equal(_pillow_decode(ours), _pillow_decode(theirs))
    assert ours == theirs


def test_encoder_writes_pillows_bytes_for_canvas_outputs(tmp_path):
    """A canvas-sized image and a binary mask, as the stitch CLI writes
    them, through `jpeg.write` and Pillow's `save(path)` defaults."""
    yy, xx = np.mgrid[0:512, 0:768]
    img = np.stack([128 + 100 * np.sin(xx / 30.0), 128 + 100 * np.cos(yy / 20.0),
                    (xx + yy) % 256], -1).astype(np.uint8)
    mask = (((xx - 300) ** 2 + (yy - 200) ** 2) < 150 ** 2).astype(
        np.uint8) * 255
    for name, a in (("img", img), ("mask", mask)):
        ours, theirs = tmp_path / f"{name}_ours.jpg", tmp_path / f"{name}.jpg"
        jpeg.write(str(ours), a)
        Image.fromarray(a).save(str(theirs))
        assert ours.read_bytes() == theirs.read_bytes(), name


@pytest.mark.parametrize("src,dst", [((480, 640), (512, 512)),
                                     ((384, 448), (512, 512)),
                                     ((1024, 1024), (512, 512)),
                                     ((512, 512), (512, 512)),
                                     ((37, 53), (512, 300)),
                                     ((600, 800), (600, 512))])
@pytest.mark.parametrize("channels", [3, 0])
def test_resize_equals_pillow_bilinear(src, dst, channels):
    a = _image(src + ((channels,) if channels else ()), seed=src[0])
    want = np.asarray(Image.fromarray(a).resize((dst[1], dst[0]),
                                                Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear(a, *dst), want)
