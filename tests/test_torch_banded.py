"""The port's banded neighbour passes (vilgod_tpu_torch/ops/banded.py and
the plain versions in ops/kernels.py) against the JAX package's XLA path
on the same numpy inputs. Counts, labels and indices must be equal and
squared distances bitwise equal, banded, at full width, and on a forced
window overflow.

Every test draws its inputs from its own fixed seed. The port computes
(q - d)**2 sums with each product and sum rounded on its own (the TPU and
CUDA kernels' arithmetic); the JAX package's XLA CPU build sometimes
contracts them into FMAs, which moves a pair sitting EXACTLY on an
un-nudged threshold (the DBSCAN core levels) across it. Threshold
comparisons against JAX therefore use off-lattice points for those
levels, and the lattice boundaries are pinned against numpy instead."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vilgod_tpu.ops import banded as jb
from vilgod_tpu.ops import pallas_kernels as jpk
from vilgod_tpu_torch.ops import banded as tb
from vilgod_tpu_torch.ops import kernels as tk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: one intra-op
    thread per worker keeps torch's thread pools from oversubscribing them
    (eight threads per worker made these tests ten times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed, n=8192, ndim=3, n_blobs=12, blob=300, invalid=300,
           lattice=True):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-30, 30, (n, ndim)).astype(np.float32)
    for i in range(n_blobs):
        c = rng.uniform(-25, 25, ndim)
        pts[i * blob:(i + 1) * blob] = c + rng.normal(0, 0.1, (blob, ndim))
    if ndim > 3:
        pts[:, 3:] = rng.uniform(0, 1, (n, ndim - 3))
    if lattice:
        # snap xyz to the 5 mm lattice the pipeline quantizes to: many
        # pairs then sit exactly on lattice-valued thresholds
        pts[:, :3] = np.round(pts[:, :3] / 0.005) * np.float32(0.005)
    mask = np.ones(n, bool)
    mask[-invalid:] = False
    return pts, mask


def _sorted(pts, mask):
    """Cell-sort with both packages; the sorts and t8 layouts must agree."""
    order_j, cid_j = jb.sort_by_cell(jnp.asarray(pts), jnp.asarray(mask))
    order_t, cid_t = tb.sort_by_cell(torch.from_numpy(pts),
                                     torch.from_numpy(mask))
    np.testing.assert_array_equal(np.asarray(order_j), order_t.numpy())
    np.testing.assert_array_equal(np.asarray(cid_j), cid_t.numpy())
    order = np.asarray(order_j)
    t8_j = np.asarray(jpk.prep_t8(jnp.asarray(pts[order]),
                                  jnp.asarray(mask[order]), 1))
    t8_t = tk.prep_t8(torch.from_numpy(pts[order]),
                      torch.from_numpy(mask[order]), 1).numpy()
    np.testing.assert_array_equal(t8_j, t8_t)
    return t8_j.copy(), np.array(cid_j)


@pytest.mark.parametrize("w_band", [4096, 1024])
def test_block_windows_equal(w_band):
    pts, mask = _scene(1)
    _, cid = _sorted(pts, mask)
    ovf = {}
    for tq in (1024, 512):
        sj, ej, oj = jb.block_windows(jnp.asarray(cid), jnp.asarray(cid), tq,
                                      w_band)
        st, et, ot = tb.block_windows(torch.from_numpy(cid),
                                      torch.from_numpy(cid), tq, w_band)
        np.testing.assert_array_equal(np.asarray(sj), st.numpy())
        np.testing.assert_array_equal(np.asarray(ej), et.numpy())
        assert bool(oj) == bool(ot)
        ovf[tq] = bool(ot)
    # a 1024-query block spans more than 1024 data ranks: the
    # forced-overflow case
    assert ovf[1024] == (w_band == 1024)


def _windows(cid, tq, w_band, full):
    """(starts, width) as the callers pick them: banded, or full width."""
    n = cid.shape[0]
    if full:
        return np.zeros(n // tq, np.int32), n
    s, _, ovf = jb.block_windows(jnp.asarray(cid), jnp.asarray(cid), tq,
                                 w_band)
    assert not bool(ovf)
    return np.array(s), w_band


@pytest.mark.parametrize("full", [False, True], ids=["banded", "full"])
@pytest.mark.parametrize("ndim", [3, 6])
def test_count_equal(ndim, full):
    pts, mask = _scene(2, ndim=ndim)
    t8, cid = _sorted(pts, mask)
    from vilgod_tpu.ops.neighbors import radius2_threshold
    r2 = radius2_threshold(0.3)
    starts, w = _windows(cid, 1024, 4096, full)
    cj = jb.banded_radius_count(jnp.asarray(t8), jnp.asarray(t8),
                                jnp.asarray(starts), r2, 1024, w, ndim=ndim)
    ct = tb.banded_radius_count(torch.from_numpy(t8), torch.from_numpy(t8),
                                torch.from_numpy(starts), r2, 1024, w,
                                ndim=ndim)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    assert ct.numpy().max() > 10  # the blobs are dense


_LEVELS2 = np.asarray([0.15, 0.15 * 2 ** 0.5, 0.3], np.float32) ** 2


def _count3(t8, starts, w, ndim):
    return tb.banded_radius_count3(
        torch.from_numpy(t8), torch.from_numpy(t8), torch.from_numpy(starts),
        torch.from_numpy(_LEVELS2), 512, w, ndim=ndim).numpy()


@pytest.mark.parametrize("full", [False, True], ids=["banded", "full"])
@pytest.mark.parametrize("ndim", [3, 6])
def test_count3_equal(ndim, full):
    pts, mask = _scene(3, ndim=ndim, lattice=False)
    t8, cid = _sorted(pts, mask)
    starts, w = _windows(cid, 512, 4096, full)
    c3j = jb.banded_radius_count3(jnp.asarray(t8), jnp.asarray(t8),
                                  jnp.asarray(starts), jnp.asarray(_LEVELS2),
                                  512, w, ndim=ndim)
    c3t = _count3(t8, starts, w, ndim)
    np.testing.assert_array_equal(np.asarray(c3j), c3t)
    assert c3t[:, 2].max() > 10


def test_count3_lattice_boundaries():
    """On the 5 mm lattice many pairs sit exactly on the un-nudged core
    levels; the count must be numpy's separately rounded one."""
    pts, mask = _scene(4, n=4096, ndim=3)
    t8, cid = _sorted(pts, mask)
    starts, w = _windows(cid, 512, 4096, True)
    c3t = _count3(t8, starts, w, 3)
    q = t8[:3, :, None]
    acc = None
    for c in range(3):
        diff = q[c] - t8[c][None, :]
        acc = diff * diff if acc is None else acc + diff * diff
    want = (acc[..., None] <= _LEVELS2).sum(axis=1)
    np.testing.assert_array_equal(want, c3t)
    on_level = np.isin(acc, _LEVELS2).sum()
    assert on_level > 0, "the scene must put pairs on the levels"


@pytest.mark.parametrize("full", [False, True], ids=["banded", "full"])
def test_min_label_equal(full):
    rng = np.random.default_rng(5)
    pts, mask = _scene(5, ndim=5, lattice=False)
    t8, cid = _sorted(pts, mask)
    n = t8.shape[1]
    r2 = rng.choice(np.asarray([0.15, 0.2, 0.3], np.float32) ** 2, n)
    labels = rng.integers(0, n, n).astype(np.int32)
    labels[rng.uniform(size=n) < 0.2] = 2 ** 30   # non-core sentinel
    starts, w = _windows(cid, 512, 4096, full)
    mj = jb.banded_min_label(jnp.asarray(t8), jnp.asarray(r2),
                             jnp.asarray(labels.astype(np.float32)),
                             jnp.asarray(starts), 512, w, 5, 2 ** 30)
    mt = tb.banded_min_label(torch.from_numpy(t8), torch.from_numpy(r2),
                             torch.from_numpy(labels),
                             torch.from_numpy(starts), 512, w, 5, 2 ** 30)
    np.testing.assert_array_equal(np.asarray(mj).astype(np.int32), mt.numpy())
    assert (mt.numpy() < labels).any()


@pytest.mark.parametrize("full", [False, True], ids=["banded", "full"])
@pytest.mark.parametrize("ndim", [3, 4])
def test_nearest_equal(ndim, full):
    pts, mask = _scene(6, ndim=ndim)
    t8, cid = _sorted(pts, mask)
    # duplicate points: ties must go to the lowest rank in both
    t8[:, 1:200:2] = t8[:, 0:199:2]
    starts, w = _windows(cid, 1024, 4096, full)
    dj, ij = jb.banded_nearest(jnp.asarray(t8), jnp.asarray(t8),
                               jnp.asarray(starts), 1024, w, ndim=ndim)
    dt, it = tb.banded_nearest(torch.from_numpy(t8), torch.from_numpy(t8),
                               torch.from_numpy(starts), 1024, w, ndim=ndim)
    np.testing.assert_array_equal(np.asarray(dj).view(np.uint32),
                                  dt.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())


def test_wrappers_check_inputs_and_count_no_cpu_launches():
    pts, mask = _scene(7, n=4096)
    t8, cid = _sorted(pts, mask)
    q = torch.from_numpy(t8)
    starts = torch.zeros(4, dtype=torch.int32)
    tk.reset_launches()
    tk.banded_tile_count(q, q, starts, 0.09, 1024, 4096)
    assert all(v == 0 for v in tk.LAUNCHES.values())  # plain on the CPU
    with pytest.raises(TypeError):
        tk.banded_tile_count(q, q, starts.long(), 0.09, 1024, 4096)
    with pytest.raises(ValueError):
        tk.banded_tile_count(q, q, starts[:3], 0.09, 1024, 4096)
    with pytest.raises(ValueError):
        tk.banded_tile_count(q, q, starts, 0.09, 1024, 8192)
    with pytest.raises(ValueError):
        tk.banded_tile_nearest(q[:, ::2], q, starts[:2], 1024, 4096)
