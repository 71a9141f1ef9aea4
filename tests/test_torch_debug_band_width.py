"""The port's ``tools/debug_band_width`` at a small size on the CPU: its
three passes against the JAX package's ``banded_radius_count3``,
``banded_min_label`` and ``banded_nearest`` (their XLA path) on the same
numpy chunk input at two widths, equal across those widths, and its
``main`` with ``--device cpu``.

JAX's XLA path scans each block's whole window, the port's passes only
the block's true span (``ends``), so they are compared where the span
decides (see tests/test_torch_banded.py): on the valid query lanes, the
nearest where it lies within the 0.5 m cell."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vilgod_tpu.ops import banded as jb
from vilgod_tpu.ops import cluster as jc
from vilgod_tpu.ops import pallas_kernels as jpk
from vilgod_tpu_torch.tools import debug_band_width

CHUNK, CAP_IN = 4, 4096
WIDTHS = (4096, 8192)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chunk_input(seed=0, occupied=3000):
    """A chunk of pages as the clustering stage lays it out: per page the
    selected points first ([xyz on the 5 mm lattice, entropy, 0.1 *
    frame offset]), then padding."""
    rng = np.random.default_rng(seed)
    feats = np.zeros((CHUNK, CAP_IN, 5), np.float32)
    fmask = np.zeros((CHUNK, CAP_IN), bool)
    for p in range(CHUNK):
        blobs = [rng.uniform(-20, 20, 3) * [1, 1, 0.05]
                 + rng.normal(scale=0.3, size=(200, 3)) for _ in range(10)]
        xyz = np.concatenate(blobs + [rng.uniform(-25, 25, (occupied - 2000,
                                                             3))])
        feats[p, :occupied, :3] = np.round(xyz / 0.005) * 0.005
        feats[p, :occupied, 3] = rng.uniform(0, 1, occupied)
        feats[p, :occupied, 4] = 0.1 * rng.integers(0, 2, occupied)
        fmask[p, :occupied] = True
    return feats, fmask


def jax_passes(feats, fmask, w):
    """The tool's three passes through the JAX package: (count3, min-label,
    (dist2, index), sorted mask)."""
    n = CHUNK * CAP_IN
    flat, mask = jnp.asarray(feats.reshape(n, 5)), jnp.asarray(
        fmask.reshape(n))
    pages = jnp.repeat(jnp.arange(CHUNK, dtype=jnp.int32), CAP_IN)
    order, cid = jc.paged_cell_sort(flat, mask, pages, CHUNK)
    iso = (pages.astype(jnp.float32) * jc.PAGE_ISO)[:, None]
    pts_t8 = jpk.prep_t8(jnp.concatenate([flat, iso], axis=1)[order],
                         mask[order], 1)
    invalid = CHUNK * jb.GRID * jb.GRID
    levels = jnp.asarray([0.15, 0.15 * 2.0 ** 0.5, 0.3], jnp.float32)
    st_h, _, _ = jb.block_windows(cid, cid, 512, w, invalid_cid=invalid)
    st_l, _, _ = jb.block_windows(cid, cid, 1024, w, invalid_cid=invalid)
    count3 = jb.banded_radius_count3(pts_t8, pts_t8, st_h, levels * levels,
                                     512, w, ndim=6)
    labels = jb.banded_min_label(pts_t8, jnp.full(n, 0.3 ** 2, jnp.float32),
                                 jnp.arange(n, dtype=jnp.int32), st_h, 512,
                                 w, 6, 2 ** 30)
    nearest = jb.banded_nearest(pts_t8, pts_t8, st_l, 1024, w, ndim=6)
    return (np.asarray(count3), np.asarray(labels),
            tuple(map(np.asarray, nearest)), np.asarray(mask[order]))


def test_debug_band_width_matches_jax_and_across_widths():
    feats, fmask = chunk_input()
    out = debug_band_width.run(inputs=(feats, fmask), widths=WIDTHS, reps=1,
                               device="cpu")
    assert [r["w_band"] for r in out["rows"]] == list(WIDTHS)
    assert not any(r["ovf_h"] or r["ovf_l"] for r in out["rows"])
    assert debug_band_width.check_widths(out) == list(WIDTHS)
    for w in WIDTHS:
        count3, labels, (d2, idx) = (x for x in out["outputs"][w])
        j_count3, j_labels, (j_d2, j_idx), valid = jax_passes(feats, fmask, w)
        np.testing.assert_array_equal(out["valid"].numpy(), valid)
        assert valid.sum() == CHUNK * 3000
        np.testing.assert_array_equal(count3.numpy()[valid], j_count3[valid])
        np.testing.assert_array_equal(labels.numpy()[valid], j_labels[valid])
        near = valid & (j_d2 < np.float32(jb.CELL ** 2))
        np.testing.assert_array_equal(idx.numpy()[near], j_idx[near])
        np.testing.assert_array_equal(d2.numpy()[near].view(np.int32),
                                      j_d2[near].view(np.int32))
        # the passes did work: cores and links beyond each point itself
        assert (count3.numpy()[valid, 2] > 1).mean() > 0.5
        assert (labels.numpy()[valid] < np.arange(len(valid))[valid]).any()


def test_check_widths_rejects_a_difference():
    feats, fmask = chunk_input(seed=1)
    out = debug_band_width.run(inputs=(feats, fmask), widths=WIDTHS, reps=1,
                               device="cpu")
    out["outputs"][WIDTHS[1]][0][7, 0] += 1
    with pytest.raises(AssertionError, match="count3 at w_band 8192"):
        debug_band_width.check_widths(out)


def test_main_on_the_cpu(capsys):
    assert debug_band_width.main(["--device", "cpu", "--scale", "smoke",
                                  "--widths", "8192", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu"
    assert lines[-1] == "# equal across the widths without overflow: [8192]"
