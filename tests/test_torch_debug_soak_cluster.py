"""The port's ``tools/debug_soak_cluster`` at a small size on the CPU: the
window dissection of a chunk (selected points a page, core points, and
each window set's largest true span and overflow flag) against the same
computation through the JAX package's functions on the same numpy
buffers, and the tool's ``main`` with ``--device cpu``."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vilgod_tpu.ops import banded as jb
from vilgod_tpu.ops import cluster as jc
from vilgod_tpu.ops import pallas_kernels as jpk
from vilgod_tpu.pipeline import stages_geometry as jsg
from vilgod_tpu_torch.pipeline.stages_geometry import frame_select_stats_all
from vilgod_tpu_torch.tools import debug_cluster_stepwise, debug_soak_cluster

FRAMES, N_NG, CHUNK, CAP_IN = 8, 4096, 4, 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_dissect(args, f0):
    """The JAX tool's dissection through the JAX package, the count on all
    six columns as the paged DBSCAN takes them."""
    stats = jsg.frame_select_stats_all(*args)
    feats, fmask, _, _ = jax.vmap(lambda i: jsg.select_cluster_input(
        *args, f0 + i, 666, stats, 2, CAP_IN))(jnp.arange(CHUNK))
    n = CHUNK * CAP_IN
    flat, mask = feats.reshape(n, 5), fmask.reshape(n)
    pages = jnp.repeat(jnp.arange(CHUNK, dtype=jnp.int32), CAP_IN)
    order, cid = jc.paged_cell_sort(flat, mask, pages, CHUNK)
    iso = (pages.astype(jnp.float32) * jc.PAGE_ISO)[:, None]
    msk_s = mask[order]
    pts_t8 = jpk.prep_t8(jnp.concatenate([flat, iso], axis=1)[order], msk_s,
                         1)
    invalid = CHUNK * jb.GRID * jb.GRID
    w_band = min(max(8192, -(-int(CAP_IN * 0.35) // 2048) * 2048), n)
    levels = jnp.asarray([0.15, 0.15 * 2.0 ** 0.5, 0.3], jnp.float32)
    s_h, _, _ = jb.block_windows(cid, cid, 512, w_band, invalid_cid=invalid)
    counts3 = jb.banded_radius_count3(pts_t8, pts_t8, s_h, levels * levels,
                                      512, w_band, ndim=6)[:n]
    _, core = jc._core_radii(counts3, msk_s, levels, levels[2], 5,
                             jnp.float32)
    core_pos = jnp.cumsum(core.astype(jnp.int32)) - 1
    core_src = jnp.full(n + 1, n, jnp.int32).at[
        jnp.where(core, core_pos, n)].set(jnp.arange(n, dtype=jnp.int32))[:n]
    cid_c = jnp.where(core_src < n, cid[jnp.minimum(core_src, n - 1)],
                      invalid)
    spans = {}
    for key, (cq, cd, tq) in {"all_TQ": (cid, cid, 1024),
                              "all_TQH": (cid, cid, 512),
                              "core_prop": (cid_c, cid_c, 512),
                              "core_nearest": (cid, cid_c, 1024)}.items():
        st, en, ovf = jb.block_windows(cq, cd, tq, w_band,
                                       invalid_cid=invalid)
        spans[key] = (int(jnp.max(en - st)), bool(ovf))
    return np.asarray(fmask.sum(1)), int(core.sum()), spans


@pytest.mark.parametrize("f0", [0, 4])
def test_dissection_matches_jax(f0):
    host = debug_cluster_stepwise.make_buffers(FRAMES, N_NG)
    args = tuple(torch.from_numpy(a) for a in host)
    sel, core, spans = debug_soak_cluster.dissect(
        args, frame_select_stats_all(*args), f0, CHUNK, CAP_IN)
    j_sel, j_core, j_spans = jax_dissect(tuple(map(jnp.asarray, host)), f0)
    np.testing.assert_array_equal(sel.numpy(), j_sel)
    assert core == j_core and core > 0
    assert spans == j_spans
    assert all(s > 0 for s, _ in spans.values())


def test_main_on_the_cpu(capsys):
    assert debug_soak_cluster.main(["--device", "cpu", "--smoke", "--frames",
                                    "8", "--launch"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu" and lines[-1] == "# OK"
    assert sum(line.startswith("# f0=") for line in lines) == 1
