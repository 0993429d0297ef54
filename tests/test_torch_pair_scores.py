"""The evaluation's scoring on the CPU: `pair_scores_plain` (K6's plain
version, stitchax_torch/ops/kernels/pair_scores.py) and `validate_with_model`
against the numpy composition the evaluation used before it scored on the
device: `evaluate.masked_pairs`, then `metrics.psnr_batch` and
`metrics.ssim_batch`. PSNR is held bit-equal (the squared error is an exact
integer and the host's finish is `metrics.psnr`'s); SSIM within 1e-12 (each
pixel's S takes numpy's float64 operations in numpy's order, only the
interior's sum takes another order).

The file imports no JAX: tests/test_torch_kernels_gpu.py holds K6 to the
same cases (`CASES`, `make_case`) on the card.
"""

import warnings

import numpy as np
import pytest
import torch

from stitchax_torch.evaluate import masked_pairs, validate_with_model
from stitchax_torch.metrics import psnr_batch, ssim_batch
from stitchax_torch.ops.kernels import library
from stitchax_torch.ops.kernels.pair_scores import (pair_scores,
                                                    pair_scores_plain,
                                                    psnr_ssim)

SSIM_TOL = 1e-12
# just below full coverage in fp32, and just above it
BELOW_ONE, ABOVE_ONE = np.float32(1 - 2 ** -24), np.float32(1 + 2 ** -23)

# (name, B, H, W): the evaluation's shapes are 512^2; these are cut to
# sizes that are not multiples of K6's 32-pixel tile, down to SSIM's 7x7
CASES = [("random", 3, 64, 80), ("masked", 2, 50, 70),
         ("odd_levels", 2, 40, 45), ("coverage_edges", 2, 33, 65),
         ("no_coverage", 1, 20, 30), ("smallest", 1, 7, 7),
         ("narrow", 2, 8, 40), ("batch_13", 13, 16, 24),
         ("channel_slice", 3, 48, 40)]


def make_case(name, B, H, W, seed=0):
    """(img1, warped, valid) float32 tensors on the CPU: img1 whole gray
    levels, warped a noisy copy (not whole levels), valid the coverage. For
    "channel_slice", warped and valid are taken from one (B, H, W, 6) warp
    output as `make_eval_step` takes them: warped a non-contiguous channel
    slice, valid the mean of the other three channels."""
    g = np.random.default_rng(seed)
    img1 = np.floor(g.random((B, H, W, 3)) * 256).astype(np.float32)
    warped = (img1 + g.normal(0, 12, img1.shape)).astype(np.float32)
    valid = np.ones((B, H, W, 1), np.float32)
    if name == "masked":
        valid[:, H // 3:, : W // 2] = 0.0
        valid[:, :, -5:] = 0.0
    elif name == "odd_levels":
        flat = warped.reshape(-1)
        idx = g.choice(flat.size, 60, replace=False)
        flat[idx[:20]] = np.nan
        flat[idx[20:30]] = -g.random(10) * 300
        flat[idx[30:40]] = 255 + g.random(10) * 300
        flat[idx[40:45]] = np.inf
        flat[idx[45:50]] = -np.inf
        flat[idx[50:]] = 254.99998
    elif name == "coverage_edges":
        choice = g.integers(0, 6, valid.shape)
        valid = np.select([choice == 0, choice == 1, choice == 2,
                           choice == 3, choice == 4],
                          [BELOW_ONE, np.float32(1.0), ABOVE_ONE,
                           np.float32(0.5), np.float32(np.nan)],
                          np.float32(0.0)).astype(np.float32)
    elif name == "no_coverage":
        valid[:] = 0.0
    img1, warped, valid = (torch.from_numpy(np.ascontiguousarray(t))
                           for t in (img1, warped, valid))
    if name == "channel_slice":
        ones = torch.from_numpy(g.random((B, H, W, 3)).astype(np.float32))
        ones[ones > 0.3] = 1.0
        out = torch.cat([warped, ones], -1)
        warped, valid = out[..., 0:3], out[..., 3:6].mean(-1, keepdim=True)
        assert not warped.is_contiguous()
    return img1, warped, valid


def numpy_scores(img1, warped, valid):
    """(PSNR, SSIM) by the numpy composition, from CPU tensors."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # NaN's cast
        a, b = masked_pairs(*(t.numpy() for t in (img1, warped, valid)))
    return psnr_batch(a, b, 255.0), ssim_batch(a, b, 7, 255.0)


def assert_scores_match(got, want):
    np.testing.assert_array_equal(got[0], want[0])            # PSNR
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=SSIM_TOL)


def test_numpy_casts_nan_to_zero():
    """`masked_pairs`' uint8 casts send NaN to 0 on this machine's numpy:
    K6 and its plain version map NaN to 0 as well."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        x = np.array([np.nan], np.float32)
        assert np.clip(x, 0, 255).astype(np.uint8)[0] == 0
        assert x.astype(np.uint8)[0] == 0


@pytest.mark.parametrize("name,B,H,W", CASES)
def test_plain_matches_numpy_metrics(name, B, H, W):
    img1, warped, valid = make_case(name, B, H, W)
    scores = pair_scores_plain(img1, warped, valid)
    assert scores.shape == (B, 4) and scores.dtype == torch.float64
    assert_scores_match(psnr_ssim(scores.numpy(), H, W),
                        numpy_scores(img1, warped, valid))


def test_a_pair_with_no_full_coverage_scores_inf_and_one():
    p, s = psnr_ssim(pair_scores_plain(*make_case("no_coverage", 1, 20,
                                                  30)).numpy(), 20, 30)
    assert p.tolist() == [float("inf")] and s.tolist() == [1.0]


def test_wrapper_takes_plain_on_cpu():
    args = make_case("random", 2, 16, 16)
    before = dict(library.launches)
    assert torch.equal(pair_scores(*args), pair_scores_plain(*args))
    assert library.launches == before


def test_pair_scores_refuses_other_shapes():
    img1, warped, valid = make_case("random", 1, 16, 16)
    with pytest.raises(ValueError):             # four channels
        pair_scores(torch.cat([img1, img1[..., :1]], -1), warped, valid)
    with pytest.raises(ValueError):             # coverage not (B, H, W, 1)
        pair_scores(img1, warped, valid[..., 0])
    small = make_case("random", 1, 6, 9)
    with pytest.raises(ValueError):             # under SSIM's window
        pair_scores(*small)


@pytest.mark.parametrize("parallel_pad", [False, True])
def test_validate_with_model_scores_as_numpy(parallel_pad):
    """`validate_with_model` on the CPU gives the per-pair lists the numpy
    composition gives: names in order, PSNR bit-equal, SSIM within 1e-12;
    with `parallel_pad` the step returns one padded row more than the batch
    (as the data-parallel gather does), which is dropped."""
    cases = [make_case("channel_slice", 3, 48, 40, seed=1),
             make_case("coverage_edges", 3, 48, 40, seed=2)]
    outputs = iter(cases)

    def eval_step(img1, img2):
        _, warped, valid = next(outputs)
        if parallel_pad:
            warped = torch.cat([warped, warped[-1:]])
            valid = torch.cat([valid, valid[-1:]])
        return warped, valid

    class Models:
        device = torch.device("cpu")

    batches = [{"image1": c[0].numpy(), "image2": c[0].numpy(),
                "name": [f"{i}-{j}" for j in range(3)]}
               for i, c in enumerate(cases)]
    per_pair = []
    report = validate_with_model(None, batches, Models(), None,
                                 eval_step=eval_step, per_pair=per_pair)
    want = [numpy_scores(*c) for c in cases]
    assert [p[0] for p in per_pair] == [n for b in batches
                                        for n in b["name"]]
    assert_scores_match(
        (np.array([p[1] for p in per_pair]), np.array([p[2] for p in
                                                       per_pair])),
        (np.concatenate([w[0] for w in want]),
         np.concatenate([w[1] for w in want])))
    assert report["num_pairs"] == 6
