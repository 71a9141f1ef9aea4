"""The port's depth-image renderer (vilgod_tpu_torch/ops/rasterize.py)
against vilgod_tpu/ops/rasterize.py on the same random clusters, in f32:
images within 1e-5, and after the uint8 round trip of the classifier at
most 0.1 % of pixels different, each by one level."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vilgod_tpu.ops import rasterize as RJ
from vilgod_tpu_torch.ops import rasterize as RT
from vilgod_tpu_torch.ops.segment import linspace0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clusters(seed, total=1024):
    """Box-shaped clusters of random size, place and point count."""
    rng = np.random.default_rng(seed)
    specs = [((8, 2, 0), (4, 2, 1.5), 600), ((-5, 10, .5), (.8, .8, 1.8), 300),
             ((3, -12, .2), (1.8, .6, 1.7), 900), ((20, 1, 0), (4.5, 2, 1.6), 1000)]
    pts = np.zeros((len(specs), total, 3), np.float32)
    mask = np.zeros((len(specs), total), bool)
    for i, (center, size, n) in enumerate(specs):
        jitter = rng.normal(0, 0.5, 3) * [1, 1, 0.1]
        pts[i, :n] = (rng.uniform(-0.5, 0.5, (n, 3)) * size + center + jitter)
        mask[i, :n] = True
    return pts, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_render_matches_jax(seed):
    pts, mask = _clusters(seed)
    want = np.asarray(RJ.render_cluster_views(jnp.asarray(pts),
                                              jnp.asarray(mask)))
    got = RT.render_cluster_views(torch.from_numpy(pts),
                                  torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (4, 4, 224, 224)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the classifier's uint8 round trip
    diff = np.abs(np.round(got * 255) - np.round(want * 255))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_cluster_to_origin_bit_equal():
    """The view normalisation as the renderer's compiled program runs it
    is bit-identical (its dot products are evaluated as XLA's fused
    multiply-add chains)."""
    pts, mask = _clusters(2)
    want = np.asarray(jax.jit(jax.vmap(RJ.cluster_to_origin))(
        jnp.asarray(pts), jnp.asarray(mask)))
    got = RT.cluster_to_origin(torch.from_numpy(pts),
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("stop,num,endpoint", [(109.0, 224, True),
                                               (2 * np.pi, 720, False),
                                               (49.0, 224, True)])
def test_linspace_bit_equal(stop, num, endpoint):
    """The resize and hull grids: jnp.linspace's f32 values bit for bit."""
    want = np.asarray(jnp.linspace(0.0, stop, num, endpoint=endpoint))
    got = linspace0(stop, num, endpoint=endpoint).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_grid_and_image_stages_match_jax():
    """Each stage alone on the same input: the z-buffer exactly, the pooled
    and smoothed image and the resize within f32 rounding."""
    pts, mask = _clusters(3)
    rots = np.asarray(RJ.euler2mat(jnp.asarray(RJ.VIEW_ANGLES)))
    np.testing.assert_allclose(RT.view_rotations().numpy(), rots, atol=1e-7)
    gj = jax.vmap(lambda p, m: RJ._points_to_grid(p, m, 112, 8, 0.8, 0.2))(
        jnp.asarray(pts), jnp.asarray(mask))
    gt = RT._points_to_grid(torch.from_numpy(pts), torch.from_numpy(mask),
                            112, 8, 0.8, 0.2)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    ij = RJ._grid_to_image(gj)
    it = RT._grid_to_image(gt)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), atol=1e-6, rtol=0)
    rj = RJ._resize_bilinear_align_corners(ij, 224, 224)
    rt = RT._resize_bilinear_align_corners(torch.from_numpy(np.asarray(ij)),
                                           224, 224)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-6, rtol=0)
