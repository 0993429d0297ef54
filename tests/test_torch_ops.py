"""The port's geometry and image ops against stitchax's, on the same numpy
inputs (fp32, CPU). Tolerances: 1e-5 absolute on O(1) values and 1e-3 on
[0, 255] images (fp32 reassociation only); masks must agree exactly unless
stated."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import stitchax.ops as jops
from stitchax.compose.inpainters import push_pull_inpaint as j_push_pull
from stitchax.compose.mix_methods import all_img1_with_inpaint as j_mix
from stitchax.ops.padding import InputPadder as JPadder
from stitchax.ops.window_attention import window_attention_split as j_wattn
from stitchax.tps import points as jpts
from stitchax.tps import solve as jsolve
from stitchax_torch.compose.inpainters import push_pull_inpaint
from stitchax_torch.compose.mix_methods import all_img1_with_inpaint
from stitchax_torch.ops import filters, flow, grid, homography, morphology
from stitchax_torch.ops import occlusion, sampling
from stitchax_torch.ops.padding import InputPadder
from stitchax_torch.ops.kernels.window_attention import window_attention
from stitchax_torch.tps import points as tpts
from stitchax_torch.tps import solve as tsolve

T = torch.from_numpy
J = jnp.asarray


def close(got, ref, atol=1e-5, rtol=0.0):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


def img(rng, *shape, scale=255.0):
    return (rng.uniform(0, 1, shape) * scale).astype(np.float32)


# ------------------------------ grid / homography ---------------------------

def test_grids():
    close(grid.coords_grid(5, 7), jops.coords_grid(5, 7))
    close(grid.normalized_grid(5, 7), jops.normalized_grid(5, 7))
    close(grid.get_rigid_mesh(48, 64, 7, 9), jops.get_rigid_mesh(48, 64, 7, 9))


def _homographies(rng, B, h, w):
    src = np.broadcast_to(np.array([[0, 0], [w, 0], [0, h], [w, h]],
                                   np.float32), (B, 4, 2)).copy()
    dst = (src + rng.uniform(-0.15, 0.15, (B, 4, 2)) * [w, h]).astype(np.float32)
    return src, dst


def test_dlt_solve_and_h2mesh(rng):
    src, dst = _homographies(rng, 3, 96, 128)
    H = homography.dlt_solve(T(src), T(dst))
    Hj = jops.dlt_solve(J(src), J(dst))
    close(H, Hj, atol=1e-5, rtol=1e-5)
    mesh = np.array(jops.get_rigid_mesh(96, 128, 7, 7))
    got = grid.h2mesh(H, T(mesh)[None].expand(3, -1, -1, -1))
    for b in range(3):
        close(got[b], jops.h2mesh(Hj[b], J(mesh)), atol=2e-3)


# ------------------------------ sampling -------------------------------------

@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample(rng, align_corners):
    im = img(rng, 2, 17, 23, 3)
    g = rng.uniform(-1.3, 1.3, (2, 11, 13, 2)).astype(np.float32)
    got = sampling.grid_sample_b(T(im), T(g), align_corners)
    for b in range(2):
        ref = jops.grid_sample(J(im[b]), J(g[b]), align_corners=align_corners)
        close(got[b], ref, atol=1e-3)


def test_bilinear_sampler(rng):
    im = img(rng, 2, 17, 23, 4)
    c = rng.uniform(-3, 26, (2, 9, 9, 2)).astype(np.float32)
    close(sampling.bilinear_sampler_b(T(im), T(c)),
          jops.bilinear_sampler_b(J(im), J(c)), atol=1e-3)


@pytest.mark.parametrize("shape,out", [((30, 41), (64, 64)),
                                       ((64, 64), (30, 41))])
def test_resize(rng, shape, out):
    im = img(rng, 2, *shape, 3)
    close(sampling.resize_image_b(T(im), *out),
          jops.resize_image_b(J(im), *out), atol=1e-3)
    close(sampling.interpolate_bilinear_b(T(im), *out),
          jops.interpolate_bilinear_b(J(im), *out), atol=1e-3)


def test_homography_warp(rng):
    im = img(rng, 2, 32, 40, 3)
    im = np.concatenate([im, np.ones_like(im)], -1)
    src, dst = _homographies(rng, 2, 32, 40)
    H = np.asarray(jops.dlt_solve(J(src), J(dst)))
    M = np.asarray(jops.scale_matrix(32.0, 40.0))
    theta = (np.linalg.inv(M) @ H @ M).astype(np.float32)
    got = sampling.homography_warp_b(T(im), T(theta), 48, 56)
    close(got, jops.homography_warp_b(J(im), J(theta), 48, 56), atol=2e-3)


# ------------------------------ flow -----------------------------------------

def test_flow_ops(rng):
    x = img(rng, 2, 20, 24, 3)
    f = rng.uniform(-4, 4, (2, 20, 24, 2)).astype(np.float32)
    close(flow.flow_warp_b(T(x), T(f)), jops.flow_warp_b(J(x), J(f)),
          atol=1e-3)
    close(flow.resize_flow_b(T(f), 33, 45), jops.resize_flow_b(J(f), 33, 45))
    m = rng.standard_normal((2, 20, 24, 576)).astype(np.float32)
    close(flow.convex_upsample_flow_b(T(f), T(m)),
          jops.convex_upsample_flow_b(J(f), J(m)), atol=2e-5)


# ------------------------------ occlusion ------------------------------------

def test_range_map(rng):
    f = rng.uniform(-3, 3, (2, 18, 22, 2)).astype(np.float32)
    close(occlusion.compute_range_map_b(T(f)),
          jops.compute_range_map_b(J(f)), atol=1e-5)


@pytest.mark.parametrize("method", ["wang", "brox", "fb_abs"])
@pytest.mark.parametrize("zeros,boundaries", [(True, True), (False, False)])
def test_occlusion(rng, method, zeros, boundaries):
    f = rng.uniform(-2, 2, (2, 18, 22, 2)).astype(np.float32)
    b = (-f + rng.uniform(-1, 1, f.shape)).astype(np.float32)
    got = occlusion.compute_occlusion_b(T(f), T(b), method, zeros, boundaries)
    ref = jops.compute_occlusion_b(J(f), J(b), method, zeros, boundaries)
    close(got, ref, atol=1e-5)


# ------------------------------ morphology -----------------------------------

def _mask(rng, *shape, p=0.7):
    return (rng.uniform(0, 1, shape) < p).astype(np.float32)


@pytest.mark.parametrize("k", [(3, 3), (11, 11), (7, 4)])
def test_dilate_erode_open(rng, k):
    m = _mask(rng, 2, 30, 34, 1)
    for tf, jf in ((morphology.dilate, jops.dilate),
                   (morphology.erode, jops.erode),
                   (morphology.morph_open, jops.morph_open)):
        close(tf(T(m), k), jf(J(m), k), atol=0)
    close(morphology.morph_open(T(m[0]), k), jops.morph_open(J(m[0]), k),
          atol=0)


def test_preprocess_occlusion_and_pools(rng):
    occ = rng.uniform(0, 1, (2, 40, 44, 1)).astype(np.float32)
    occ = (occ > 0.1).astype(np.float32)
    close(morphology.preprocess_occlusion_mask(T(occ), (19, 19)),
          jops.preprocess_occlusion_mask(J(occ), (19, 19)), atol=0)
    x = img(rng, 1, 25, 31, 2)
    close(morphology.avg_pool_same(T(x), 7), jops.avg_pool_same(J(x), 7),
          atol=1e-3)
    m = _mask(rng, 40, 44, 3, p=0.2)
    close(morphology.dilate_thin_area(T(m)), jops.dilate_thin_area(J(m)),
          atol=0)
    close(morphology.dilate_binary(T(m), 7), jops.dilate_binary(J(m), 7),
          atol=0)


# ------------------------------ padding / filters / attention ----------------

@pytest.mark.parametrize("mode", ["sintel", "downzero", "kitti"])
def test_input_padder(rng, mode):
    x = img(rng, 1, 21, 30, 3)
    tp, jp = InputPadder(x.shape, mode), JPadder(x.shape, mode)
    got, ref = tp.pad(T(x))[0], jp.pad(J(x))[0]
    close(got, ref, atol=0)
    close(tp.unpad(got), jp.unpad(ref), atol=0)


def test_filters(rng):
    g = img(rng, 20, 24)
    close(filters.sobel_magnitude(T(g)), jops.sobel_magnitude(J(g)), atol=1e-3)
    im = img(rng, 6, 7, 3)
    close(filters.rgb_to_gray(T(im)), jops.rgb_to_gray(J(im)), atol=1e-4)


@pytest.mark.parametrize("H,W", [(14, 14), (10, 17)])
def test_window_attention(rng, H, W):
    C, ws, heads = 32, 7, 4
    qx, kx, vx = (rng.standard_normal((2, H, W, C)).astype(np.float32)
                  for _ in range(3))
    qb, kb = (rng.standard_normal((ws * ws, C)).astype(np.float32)
              for _ in range(2))
    vb = rng.standard_normal((1, C)).astype(np.float32)
    got = window_attention(T(qx), T(kx), T(vx), T(qb), T(kb), T(vb),
                           heads=heads, ws=ws)
    ref = j_wattn(J(qx), J(kx), J(vx), J(qb), J(kb), J(vb), heads=heads,
                  ws=ws)
    close(got, ref, atol=2e-5)


# ------------------------------ TPS points / solve ---------------------------

def test_border_points(rng):
    im = img(rng, 60, 76, 3)
    grad_j = np.array(jpts.gradient_magnitude_l1(J(im)))
    close(tpts.gradient_magnitude_l1(T(im)), grad_j, atol=1e-2)
    got = tpts.multi_level_border_points(T(im), 8, 8, 4)
    ref = jpts.multi_level_border_points(J(im), 8, 8, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # one gradient map for both, quantized so that windows hold ties: each
    # side must return the first maximum in window row-major order
    tied = np.floor(grad_j / 200.0) * 200.0
    step = 76 // 8
    for pad in jpts.multi_level_pads(60, 76, step, 4):
        np.testing.assert_array_equal(
            tpts.sample_border_points(T(tied), step, pad).numpy(),
            np.asarray(jpts.sample_border_points(J(tied), step, pad)))
    f = rng.uniform(-12, 12, (60, 76, 2)).astype(np.float32)
    for a, b in zip(tpts.point_pairs(got, T(f)), jpts.point_pairs(ref, J(f))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("variant", ["opencv", "kornia"])
def test_tps_warp_image(rng, variant):
    H, W, N = 40, 52, 24
    im = img(rng, H, W, 4)
    src = rng.uniform(0, 1, (N, 2)).astype(np.float32) * [W, H]
    dst = (src + rng.uniform(-2, 2, (N, 2))).astype(np.float32)
    valid = rng.uniform(0, 1, N) < 0.8
    kw, aw = tsolve.tps_fit(T(dst / [W, H]).float(), T(src / [W, H]).float(),
                            T(valid), variant)
    kwj, awj = jsolve.tps_fit(J(dst / [W, H], jnp.float32),
                              J(src / [W, H], jnp.float32), J(valid), variant)
    close(kw, kwj, atol=2e-3, rtol=1e-3)
    close(aw, awj, atol=1e-4, rtol=1e-4)
    got = tsolve.tps_warp_image(T(im), T(src), T(dst), T(valid), variant)
    ref = jsolve.tps_warp_image(J(im), J(src), J(dst), J(valid), variant)
    # fp32 solve of a (N+3)^2 system: sub-1e-3 px maps, <= 0.1 on [0, 255]
    close(got, ref, atol=0.1)


def test_tps_without_valid_points_is_identity(rng):
    """No valid control point leaves the affine part undetermined: the
    singular system gives a NaN map in stitchax and in the port alike (not
    the identity), and the TPS-warped image samples zero there in both."""
    N, H, W = 12, 20, 28
    src = (rng.uniform(0, 1, (N, 2)) * [W, H]).astype(np.float32)
    valid = np.zeros(N, bool)
    ref = np.asarray(jsolve.tps_backward_warp(J(src), J(src + 1), J(valid),
                                              H, W))
    got = tsolve.tps_backward_warp(T(src), T(src + 1), T(valid), H, W)
    assert np.isnan(ref).all()
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
    im = img(rng, H, W, 3)
    ref_im = np.asarray(jsolve.tps_warp_image(J(im), J(src), J(src + 1),
                                              J(valid)))
    got_im = tsolve.tps_warp_image(T(im), T(src), T(src + 1), T(valid))
    assert not ref_im.any()
    np.testing.assert_array_equal(got_im.numpy(), ref_im)


# ------------------------------ compose --------------------------------------

def test_push_pull_inpaint(rng):
    im = img(rng, 37, 45, 3)
    hole = np.zeros((37, 45, 1), np.float32)
    hole[8:20, 10:30] = 1
    hole[25:27, :] = 1
    close(push_pull_inpaint(T(im), T(hole)), j_push_pull(J(im), J(hole)),
          atol=1e-3)


def test_all_img1_with_inpaint(rng):
    H, W = 48, 56
    out1, warp, fw = (img(rng, H, W, 3) for _ in range(3))
    m1 = np.zeros((H, W, 1), np.float32)
    m1[:, :36] = 1
    wm = np.zeros((H, W, 1), np.float32)
    wm[4:44, 20:] = 1
    occ = _mask(rng, H, W, 1, p=0.9)
    got = all_img1_with_inpaint(T(warp), T(wm), T(out1), T(m1), T(fw), T(occ),
                                inpaint=push_pull_inpaint)
    ref = j_mix(J(warp), J(wm), J(out1), J(m1), J(fw), J(occ),
                inpaint=j_push_pull, inpainter_name="cv_inpainter")
    for name in ("tps_final_warp", "tps_final_warp_mask", "inpaint_img",
                 "inpaint_area_mask"):
        close(getattr(got, name), getattr(ref, name), atol=1e-3)
