"""The port's box geometry (vilgod_tpu_torch/ops/boxes.py, batched over
clusters) against vilgod_tpu/ops/boxes.py vmapped and jitted as its
stages run it, on the same numpy inputs.

The sweep's chosen angle must be equal (so its index is): the port
reproduces XLA's constant-folded cosines and its fused projections there.
Corners and boxes agree within 2e-5 m: XLA evaluates the cosine of a
data-dependent angle with its own float32 routine, which is not correctly
rounded (ROADMAP, faults). IoU within 1e-5, with the same zero pattern;
membership and counts equal."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vilgod_tpu.ops import boxes as JB
from vilgod_tpu.pipeline import stages_boxes as JS
from vilgod_tpu_torch.ops import boxes as TB
from vilgod_tpu_torch.pipeline import stages_boxes as TS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_cluster.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _clusters(rng, b=24, p=256):
    """(B, P, 3) rotated box-like clusters of 2..P points far from the
    origin (as in a sequence's world frame), with their masks."""
    pts = np.zeros((b, p, 3), np.float32)
    mask = np.zeros((b, p), bool)
    for i in range(b):
        n = int(rng.integers(2, p)) if i % 6 else 2
        theta = rng.uniform(0, np.pi)
        rot = np.array([[np.cos(theta), -np.sin(theta)],
                        [np.sin(theta), np.cos(theta)]])
        size = rng.uniform([0.4, 0.4], [4.5, 2.0])
        xy = rng.uniform(0, 1, (n, 2)) * size @ rot.T + rng.uniform(-40, 40, 2)
        pts[i, :n, :2] = xy
        pts[i, :n, 2] = rng.uniform(-1.5, 0.5) + rng.uniform(0, 1.8, n)
        mask[i, :n] = True
    return pts, mask


def _jax_fit(fn, **kw):
    return jax.jit(jax.vmap(lambda p, m: fn(p, m, **kw)))


@pytest.mark.parametrize("step", [0.5, 0.25])
def test_min_area_rect_matches_jax(step):
    rng = np.random.default_rng(41)
    pts, mask = _clusters(rng)
    jc, ja, jarea = (np.asarray(a) for a in _jax_fit(
        JB.min_area_rect, step_deg=step)(jnp.asarray(pts[..., :2]),
                                         jnp.asarray(mask)))
    tc, ta, tarea = TB.min_area_rect(_t(pts[..., :2]), _t(mask), step)
    np.testing.assert_array_equal(ta.numpy(), ja)      # the chosen angle
    np.testing.assert_array_equal(tarea.numpy(), jarea)
    np.testing.assert_allclose(tc.numpy(), jc, atol=2e-5, rtol=0)
    assert (ja != 0).sum() > 10 and (jarea == 0).sum() >= 3


@pytest.mark.parametrize("name,kw", [("closeness_rect", {"delta_deg": 2.0}),
                                     ("variance_rect", {"delta_deg": 1.0}),
                                     ("pca_rect", {})])
def test_other_rect_fits_match_jax(name, kw):
    rng = np.random.default_rng(42)
    pts, mask = _clusters(rng)
    keep = mask.sum(axis=1) >= 3
    pts, mask = pts[keep], mask[keep]
    jc, ja, jarea = (np.asarray(a) for a in _jax_fit(
        getattr(JB, name), **kw)(jnp.asarray(pts[..., :2]),
                                 jnp.asarray(mask)))
    tc, ta, tarea = getattr(TB, name)(_t(pts[..., :2]), _t(mask), **kw)
    np.testing.assert_allclose(tarea.numpy(), jarea, rtol=1e-5, atol=1e-6)
    if name == "pca_rect":
        # eigenvectors are defined up to sign: the axis, not its direction
        d = np.mod(ta.numpy() - ja + np.pi / 2, np.pi) - np.pi / 2
        assert np.abs(d).max() < 1e-5
    else:
        np.testing.assert_array_equal(ta.numpy(), ja)
        np.testing.assert_allclose(tc.numpy(), jc, atol=2e-5, rtol=0)


def _boxes(rng, n=40, spread=6.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform([0.5, 0.4, 0.5], [5.0, 2.5, 2.5], (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_box_corners_match_jax():
    b = _boxes(np.random.default_rng(43))
    np.testing.assert_allclose(TB.box_corners_bev(_t(b)).numpy(),
                               np.asarray(JB.box_corners_bev(jnp.asarray(b))),
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(TB.box_corners_3d(_t(b)).numpy(),
                               np.asarray(JB.box_corners_3d(jnp.asarray(b))),
                               atol=2e-6, rtol=0)


def test_points_in_boxes_and_heights_match_jax():
    rng = np.random.default_rng(44)
    b = _boxes(rng, n=12)
    pts = rng.uniform(-7, 7, (4000, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 2, 4000)
    pm = rng.uniform(size=4000) > 0.1
    want = np.asarray(JB.points_in_boxes(jnp.asarray(pts), jnp.asarray(b),
                                         point_mask=jnp.asarray(pm)))
    got = TB.points_in_boxes(_t(pts), _t(b), point_mask=_t(pm)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).sum() > 200
    np.testing.assert_allclose(
        TB.get_box_heights(_t(pts), _t(b), point_mask=_t(pm)).numpy(),
        np.asarray(JB.get_box_heights(jnp.asarray(pts), jnp.asarray(b),
                                      jnp.asarray(pm))), atol=1e-6, rtol=0)


def test_iou_matrices_match_jax():
    rng = np.random.default_rng(45)
    a, b = _boxes(rng, 30, spread=3.0), _boxes(rng, 25, spread=3.0)
    b[:5] = a[:5]                       # identical pairs
    b[5:8] = a[5:8] + [0.3, -0.2, 0.1, 0, 0, 0, 0.2]
    for name in ("iou_bev_matrix", "iou3d_matrix"):
        want = np.asarray(getattr(JB, name)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(TB, name)(_t(a), _t(b)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got == 0, want == 0)
        assert (want > 0).sum() > 50 and np.allclose(np.diag(want)[:5], 1,
                                                     atol=1e-4)


def test_bin_angles_matches_jax():
    rng = np.random.default_rng(46)
    ang = rng.uniform(-7, 7, 300).astype(np.float32)
    ang[:80] = np.float32(0.7) + rng.normal(0, 0.01, 80).astype(np.float32)
    m = rng.uniform(size=300) > 0.2
    jc, jm = JB.bin_angles(jnp.asarray(ang), jnp.asarray(m))
    tc, tm = TB.bin_angles(_t(ang), _t(m))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert float(tm) == pytest.approx(float(jm), abs=1e-6)


@pytest.mark.parametrize("method,margs", [
    ("minimum_bounding_rectangle", ()),
    ("closeness_rectangle", (("delta_deg", 2.0),))])
def test_static_box_fits_match_jax(method, margs):
    """The stage's batched simple fit: rectangle, long side first, z
    extent and the 0.3 m height pad."""
    rng = np.random.default_rng(47)
    pts, mask = _clusters(rng, b=32)
    want = np.asarray(JS._fit_static_boxes(jnp.asarray(pts), jnp.asarray(mask),
                                           method=method, margs=margs))
    got = TS._fit_static_boxes(_t(pts), _t(mask), method=method,
                               margs=dict(margs)).numpy()
    np.testing.assert_array_equal(got[:, 6], want[:, 6])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_heading_box_fits_match_jax():
    rng = np.random.default_rng(48)
    pts, mask = _clusters(rng, b=32)
    angles = rng.uniform(-np.pi, np.pi, 32).astype(np.float32)
    jb, jc, jz = (np.asarray(a) for a in JS._fit_heading_boxes(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(angles)))
    tb, tc, tz = TS._fit_heading_boxes(_t(pts), _t(mask), _t(angles))
    np.testing.assert_allclose(tb.numpy(), jb, atol=2e-5, rtol=0)
    np.testing.assert_allclose(tc.numpy(), jc, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(tz.numpy(), jz)
