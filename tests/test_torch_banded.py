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


# ---------------------------------------------------------------------------
# the true span (``ends``) of the four banded passes
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_banded_pallas(monkeypatch):
    """The JAX package's banded passes on their Pallas kernels (which take
    each block's span), interpreted on the CPU. Nothing in the JAX package
    changes; JAX's caches are cleared so no other trace is reused."""
    import jax
    from jax.experimental import pallas as pl

    pallas_call = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return pallas_call(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.setattr(jb, "_use_pallas", lambda: True)
    jax.clear_caches()
    yield
    jax.clear_caches()


# each pass's query tile, and the empty span's result per lane
TQ_OF = {"count": 1024, "count3": 512, "min_label": 512, "nearest": 1024}


def _span_inputs(kernel, ndim, seed, invalid=300):
    """A sorted cloud, the pass's tq, its band windows (starts, ends) and,
    for the min-label pass, mixed radii and labels with 20 % at 2**30."""
    # the nudged count threshold and the nearest (no threshold) take the
    # 5 mm lattice; the unnudged DBSCAN levels of count3 and the min-label
    # pass take off-lattice points (see the module docstring)
    pts, mask = _scene(seed, ndim=ndim, lattice=kernel in ("count", "nearest"),
                       invalid=invalid)
    t8, cid = _sorted(pts, mask)
    n = t8.shape[1]
    tq = TQ_OF[kernel]
    starts, ends, ovf = jb.block_windows(jnp.asarray(cid), jnp.asarray(cid),
                                         tq, 4096)
    assert not bool(ovf)
    rng = np.random.default_rng(seed)
    r2 = rng.choice(np.asarray([0.15, 0.2, 0.3], np.float32) ** 2, n)
    labels = rng.integers(0, n, n).astype(np.int32)
    labels[rng.uniform(size=n) < 0.2] = 2 ** 30
    return t8, tq, np.array(starts), np.array(ends), r2, labels


def _outs(out):
    """A pass's result as a tuple of numpy arrays (the nearest has two)."""
    return tuple(o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
                 for o in (out if isinstance(out, tuple) else (out,)))


def _port_pass(kernel, t8, tq, starts, w, ndim, r2, labels, ends=None):
    """The port's banded pass (plain versions on CPU tensors)."""
    ends = None if ends is None else torch.from_numpy(ends)
    t, st = torch.from_numpy(t8), torch.from_numpy(starts)
    if kernel == "count":
        from vilgod_tpu_torch.ops.neighbors import radius2_threshold
        out = tb.banded_radius_count(t, t, st, radius2_threshold(0.3), tq, w,
                                     ndim=ndim, ends=ends)
    elif kernel == "count3":
        out = tb.banded_radius_count3(t, t, st, torch.from_numpy(_LEVELS2),
                                      tq, w, ndim=ndim, ends=ends)
    elif kernel == "nearest":
        out = tb.banded_nearest(t, t, st, tq, w, ndim=ndim, ends=ends)
    else:
        out = tb.banded_min_label(t, torch.from_numpy(r2),
                                  torch.from_numpy(labels), st, tq, w, ndim,
                                  2 ** 30, ends=ends)
    return _outs(out)


def _jax_pass(kernel, t8, tq, starts, w, ndim, r2, labels, ends=None):
    """The JAX package's banded pass: the XLA fallback without ``ends``, or
    whatever ``_use_pallas`` picks."""
    ends = None if ends is None else jnp.asarray(ends)
    t, st = jnp.asarray(t8), jnp.asarray(starts)
    if kernel == "count":
        from vilgod_tpu.ops.neighbors import radius2_threshold
        out = jb.banded_radius_count(t, t, st, radius2_threshold(0.3), tq, w,
                                     ndim=ndim, ends=ends)
    elif kernel == "count3":
        out = jb.banded_radius_count3(t, t, st, jnp.asarray(_LEVELS2), tq, w,
                                      ndim=ndim, ends=ends)
    elif kernel == "nearest":
        out = jb.banded_nearest(t, t, st, tq, w, ndim=ndim, ends=ends)
    else:
        out = jb.banded_min_label(t, jnp.asarray(r2),
                                  jnp.asarray(labels.astype(np.float32)), st,
                                  tq, w, ndim, 2 ** 30, ends=ends)
        out = np.asarray(out).astype(np.int32)
    return _outs(out)


def _assert_lanes_equal(want, got, lanes):
    for wa, ga in zip(want, got):
        if ga.dtype == np.float32:      # squared distances: bitwise
            wa, ga = wa.view(np.uint32), ga.view(np.uint32)
        np.testing.assert_array_equal(wa[lanes], ga[lanes])


@pytest.mark.parametrize("kernel,ndim", [("count", 3), ("count", 6),
                                         ("count3", 6), ("min_label", 5),
                                         ("nearest", 4)])
def test_span_equals_jax(kernel, ndim, jax_banded_pallas):
    """The port's span pass equals, on every valid query lane, the JAX XLA
    fallback over the whole band and the JAX Pallas kernel (interpreted)
    over its tile-rounded spans. The nearest, on the valid lanes whose
    whole-band nearest lies within the cell: beyond it the span's nearest
    may differ by design (vilgod_tpu/ops/banded.py:303-308)."""
    t8, tq, starts, ends, r2, labels = _span_inputs(kernel, ndim, seed=11)
    valid = t8[0] < tk.SENTINEL
    w = 4096
    # the spans skip most of the band
    assert (ends - starts).sum() < 0.75 * starts.size * w
    got = _port_pass(kernel, t8, tq, starts, w, ndim, r2, labels, ends)
    jb_use = jb._use_pallas
    jb._use_pallas = lambda: False
    try:
        xla = _jax_pass(kernel, t8, tq, starts, w, ndim, r2, labels)
    finally:
        jb._use_pallas = jb_use
    lanes = valid
    if kernel == "nearest":
        lanes = valid & (xla[0] < np.float32(tb.CELL ** 2))
        assert lanes.sum() > 0.9 * valid.sum()
    pallas = _jax_pass(kernel, t8, tq, starts, w, ndim, r2, labels, ends)
    _assert_lanes_equal(pallas, got, lanes)
    _assert_lanes_equal(xla, got, lanes)
    if kernel in ("count", "count3"):
        assert got[0].max() > 10
    elif kernel == "min_label":
        assert (got[0][valid] < labels[valid]).any()


def _span_oracle(kernel, t8, tq, starts, ends, w, ndim, r2, labels, big):
    """numpy: block b scans exactly [s_b, min(ends[b], s_b + w)), s_b
    clamped into [0, n - w], squared distances rounded step by step; the
    nearest takes the first minimum, (inf, 0) on an empty span."""
    n = t8.shape[1]
    from vilgod_tpu_torch.ops.neighbors import radius2_threshold
    thr = np.float32(radius2_threshold(0.3))
    out = {"count": (np.zeros(n, np.int32),),
           "count3": (np.zeros((n, 3), np.int32),),
           "min_label": (np.full(n, big, np.int32),),
           "nearest": (np.full(n, np.inf, np.float32),
                       np.zeros(n, np.int32))}[kernel]
    for b, (s, e) in enumerate(zip(starts, ends)):
        s = min(max(int(s), 0), n - w)
        e = max(s, min(int(e), s + w))
        qs = slice(b * tq, (b + 1) * tq)
        acc = None
        for c in range(ndim):
            diff = t8[c, qs, None] - t8[c, None, s:e]
            acc = diff * diff if acc is None else acc + diff * diff
        if e == s:
            continue
        if kernel == "count":
            out[0][qs] = (acc <= thr).sum(axis=1)
        elif kernel == "count3":
            out[0][qs] = (acc[..., None] <= _LEVELS2).sum(axis=1)
        elif kernel == "nearest":
            out[0][qs] = acc.min(axis=1)
            out[1][qs] = s + acc.argmin(axis=1)
        else:
            hit = acc <= np.maximum(r2[qs, None], r2[None, s:e])
            out[0][qs] = np.where(hit, labels[None, s:e], big).min(axis=1)
    return out


@pytest.mark.parametrize("spans", ["block_windows", "arbitrary"])
@pytest.mark.parametrize("kernel,ndim", [("count", 3), ("count3", 6),
                                         ("min_label", 5), ("nearest", 4)])
def test_span_oracle_all_lanes(kernel, ndim, spans):
    """The span contract on every lane, invalid ones included: an
    all-invalid block (empty span) gives 0 / big / (inf, 0), a span ending
    inside a 256-point chunk is cut exactly there."""
    # 1500 invalid points: the last query block holds no valid point
    t8, tq, starts, ends, r2, labels = _span_inputs(kernel, ndim, seed=12,
                                                    invalid=1500)
    w, big = 4096, 2 ** 30
    if kernel == "nearest":
        # duplicate points: ties must go to the lowest rank
        t8[:, 1:200:2] = t8[:, 0:199:2]
    if spans == "arbitrary":
        # every block but the all-invalid last one
        rng = np.random.default_rng(13)
        ends[:-1] = starts[:-1] + rng.integers(-8, w + 300, starts.size - 1)
        ends[1] = starts[1] + 300          # ragged, inside the second chunk
        ends[2] = starts[2] - 5            # empty
        ends[3] = starts[3] + w + 1000     # past the band: clamped
    empty = ends <= starts
    ragged = ((ends - starts) % 256 != 0) & ~empty
    assert empty[-1] and ragged.any()
    got = _port_pass(kernel, t8, tq, starts, w, ndim, r2, labels, ends)
    want = _span_oracle(kernel, t8, tq, starts, ends, w, ndim, r2, labels,
                        big)
    _assert_lanes_equal(want, got, slice(None))
    empty_value = {"count": (0,), "count3": (0,), "min_label": (big,),
                   "nearest": (np.inf, 0)}[kernel]
    for g, v in zip(got, empty_value):
        assert (g.reshape(starts.size, tq, -1)[empty] == v).all()


def test_span_none_is_the_whole_window():
    """``ends=None`` is the full window, and an ``ends`` at or past
    ``start + w`` for every block gives the same counts on every lane."""
    t8, tq, starts, _, r2, labels = _span_inputs("count", 3, seed=14)
    whole = _port_pass("count", t8, tq, starts, 4096, 3, r2, labels)
    past = np.full(starts.shape, t8.shape[1] + 4096, np.int32)
    np.testing.assert_array_equal(
        whole, _port_pass("count", t8, tq, starts, 4096, 3, r2, labels, past))


def test_wrappers_check_ends():
    pts, mask = _scene(7, n=4096)
    t8, _ = _sorted(pts, mask)
    q = torch.from_numpy(t8)
    starts = torch.zeros(4, dtype=torch.int32)
    r2 = torch.full((4096,), 0.09)
    lab = torch.zeros(4096, dtype=torch.int32)
    with pytest.raises(TypeError):
        tk.banded_tile_count(q, q, starts, 0.09, 1024, 4096,
                             ends=starts.long())
    with pytest.raises(ValueError):
        tk.banded_tile_count(q, q, starts, 0.09, 1024, 4096,
                             ends=starts[:3].contiguous())
    with pytest.raises(ValueError):
        tk.banded_tile_min_label(q, r2, lab, starts[:2].contiguous(), 2048,
                                 4096, 3, 2 ** 30, ends=starts)
    with pytest.raises(TypeError):
        tk.banded_tile_nearest(q, q, starts, 1024, 4096, ends=starts.float())
    with pytest.raises(ValueError):
        tk.banded_tile_count3(q, q, starts, torch.zeros(3), 1024, 4096,
                              ends=starts[:3].contiguous())


def _record_calls(monkeypatch):
    """Patch the four wrappers to record (name, w, ends) per call."""
    import inspect
    calls = []
    for name in tk.KERNEL_NAMES:
        fn = getattr(tk, name)

        def record(*args, _fn=fn, _name=name, _sig=inspect.signature(fn),
                   **kwargs):
            a = _sig.bind(*args, **kwargs)
            a.apply_defaults()
            calls.append((_name, a.arguments["w"], a.arguments["ends"]))
            return _fn(*args, **kwargs)
        monkeypatch.setattr(tk, name, record)
    return calls


def _paged_transfer(layout, rng):
    """Two pages of 4096 queries and 16384 data points (3-D) for
    knn_labels_paged, whose band is 8192 ranks, its middle tier 16384 and
    its full width 32768. ``spread``: every block fits the band; ``strip``:
    the data in a 1.5 m strip, so a block's span holds most of its page
    (the middle tier); ``unbalanced``: that strip with 24576 of the points
    in page 0 (full width). Each query lies near a data point of its
    page."""
    nq, nd = 4096, 16384
    d = rng.uniform(-30, 30, (2 * nd, 3)).astype(np.float32)
    if layout != "spread":
        d[:, 0] = rng.uniform(0.1, 1.6, 2 * nd)
    dp = np.repeat(np.arange(2, dtype=np.int32), nd)
    if layout == "unbalanced":
        dp[:24576], dp[24576:] = 0, 1
    qp = np.repeat(np.arange(2, dtype=np.int32), nq)
    near = np.concatenate([rng.choice(np.flatnonzero(dp == p), nq)
                           for p in range(2)])
    q = (d[near] + rng.normal(0, 0.05, (2 * nq, 3))).astype(np.float32)
    return (q, np.ones(2 * nq, bool), qp, d, np.ones(2 * nd, bool), dp, 2,
            rng.integers(-1, 40, 2 * nd).astype(np.int32),
            rng.uniform(0, 1, 2 * nd).astype(np.float32))


@pytest.mark.parametrize("forced_overflow", [False, True],
                         ids=["banded", "overflow"])
def test_call_sites_pass_ends(forced_overflow, monkeypatch):
    """Every caller the JAX package runs with ``ends`` passes it: the radius
    count, the entropy pair counts, the DBSCAN core counts, min-label
    rounds and border attach, and the label transfers; on a window
    overflow the full-width re-run takes none (``knn_labels`` then takes
    the dense knn, as in JAX). The overflow is forced with a 512-rank band:
    narrower than every query block (1024 and 512 queries), whose span
    holds at least its own valid points; for ``knn_labels_paged``, whose
    band is its pages' capacity, by one page holding most of the points."""
    from vilgod_tpu_torch.ops import cluster as tc
    from vilgod_tpu_torch.ops import entropy as te
    from vilgod_tpu_torch.ops import neighbors as tn

    calls = _record_calls(monkeypatch)
    if forced_overflow:
        for mod in (tn, te, tc):
            monkeypatch.setattr(mod, "band_width", lambda n, tile=2048: 512)

    pts, mask = _scene(8, ndim=5, lattice=False)
    xyz, m = torch.from_numpy(pts[:, :3].copy()), torch.from_numpy(mask)
    tn.radius_count(xyz, m, xyz, m, 0.3)
    te.entropy_sequence(torch.stack([xyz, xyz.flip(0)]), torch.stack([m, m]),
                        torch.ones(2, dtype=torch.bool), window=2,
                        skip_frames=0)
    tc.dbscan_labels(torch.from_numpy(pts), m)
    lab = torch.arange(8192, dtype=torch.int32)
    tn.knn_labels(xyz, m, xyz.flip(0).contiguous(), m, lab)
    paged = _paged_transfer("unbalanced" if forced_overflow else "spread",
                            np.random.default_rng(9))
    tn.knn_labels_paged(*(torch.from_numpy(a) if isinstance(a, np.ndarray)
                          else a for a in paged))
    names = [c[0] for c in calls]
    # one radius count, 2 x 2 entropy pairs, one DBSCAN core count, at
    # least one min-label round, one border attach, the label transfers
    assert names.count("banded_tile_count") == 5
    assert names.count("banded_tile_count3") == 1
    assert "banded_tile_min_label" in names
    assert names.count("banded_tile_nearest") == (2 if forced_overflow else 3)
    if forced_overflow:
        assert all(ends is None for _, _, ends in calls)
    else:
        assert all(ends is not None for _, _, ends in calls)


@pytest.mark.parametrize("layout,w", [("spread", 8192), ("strip", 16384),
                                      ("unbalanced", 32768)])
def test_knn_labels_paged_tiers(layout, w, monkeypatch):
    """``knn_labels_paged``'s three tiers: the band and the 2x middle tier
    pass their own spans' ends, the full-width pass none; the labels and
    probabilities equal the JAX package's."""
    from vilgod_tpu.ops import neighbors as jn
    from vilgod_tpu_torch.ops import neighbors as tn

    calls = _record_calls(monkeypatch)
    args = _paged_transfer(layout, np.random.default_rng(10))
    lt, pt = tn.knn_labels_paged(*(torch.from_numpy(a)
                                   if isinstance(a, np.ndarray) else a
                                   for a in args))
    assert [(c[0], c[1]) for c in calls] == [("banded_tile_nearest", w)]
    ends = calls[0][2]
    assert (ends is None) == (w == 32768)
    lj, pj = jn.knn_labels_paged(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                   else a for a in args))
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    assert (lt.numpy() >= 0).mean() > 0.5
