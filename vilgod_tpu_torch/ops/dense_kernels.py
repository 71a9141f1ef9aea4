"""The dense (all-pairs) neighbour kernels: CUDA wrappers, plain PyTorch
versions and launch counts. The port of the five dense ``tile_*`` kernels
of ``vilgod_tpu/ops/pallas_kernels.py``: four on the small-input and
overflow paths of ``ops/neighbors.py``, ``ops/entropy.py`` and
``ops/cluster.py``, and ``tile_min_label_qd``, which has no caller in
either package (the per-block min-label pass that the single-launch banded
kernels replaced).

Layout as in ``ops/kernels.py``: clouds are ``(8, N)`` float32 from
:func:`~vilgod_tpu_torch.ops.kernels.prep_t8` with invalid points at the
far sentinel; every query meets every data point; squared distances are
``(q - d)**2`` summed over rows 0..ndim-1 in order, each product and sum
rounded on its own, so kernel and plain version agree bit for bit.
Indices are into the caller's data order.

Each wrapper takes its plain version only for CPU tensors. For CUDA
tensors it launches its kernel from ``csrc/dense.cu`` (built by
``utils/cuda_build.py`` at first use) or raises; it never falls back.
``LAUNCHES`` counts kernel launches per wrapper.

Kernels 6-9 and 12 (``tile_radius_count``, ``tile_radius_count3``,
``tile_min_label``, ``tile_nearest``, ``tile_min_label_qd``) decide whole
(warp query group, data chunk) tiles by bounding boxes before the pair
loop: skipped, taken whole (the counts), or left to the pair loop, each
decision exact. Kernels 8 and 12 share one CUDA kernel: kernel 8 is its
call with one cloud on both sides.
:func:`tile_decisions` mirrors them in torch on the same boxes, for the
tests and for ``chip_smoke.py``'s needed-pair bounds; on the card each
kernel writes its own decisions where asked (``tiles=``), so that the
mirror can be held to them.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import CudaLibrary, launch, stream_of
from .kernels import SENTINEL, _check, _dist2_t8, _plain_chunk

KERNEL_NAMES = ("tile_radius_count", "tile_radius_count3", "tile_min_label",
                "tile_nearest", "tile_min_label_qd")
LAUNCHES = {name: 0 for name in KERNEL_NAMES}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _columns(q_t8, d_t8, ndim):
    """(first column, dist2 tile (Nq, chunk)) over all data columns."""
    n_d = d_t8.shape[1]
    chunk = _plain_chunk(q_t8.device)
    for k in range(0, n_d, chunk):
        yield k, _dist2_t8(q_t8, d_t8[:, k:k + chunk], ndim)


def count_plain(q_t8, d_t8, r2, ndim):
    out = torch.zeros(q_t8.shape[1], dtype=torch.int32, device=q_t8.device)
    for _, dist2 in _columns(q_t8, d_t8, ndim):
        out += (dist2 <= r2).sum(dim=1, dtype=torch.int32)
    return out


def count3_plain(q_t8, d_t8, levels2, ndim):
    out = torch.zeros((q_t8.shape[1], 3), dtype=torch.int32,
                      device=q_t8.device)
    for _, dist2 in _columns(q_t8, d_t8, ndim):
        for lv in range(3):
            out[:, lv] += (dist2 <= levels2[lv]).sum(dim=1, dtype=torch.int32)
    return out


def min_label_plain(pts_t8, radius2, labels, ndim, big):
    return min_label_qd_plain(pts_t8, pts_t8, radius2, radius2, labels, ndim,
                              big)


def min_label_qd_plain(q_t8, d_t8, q_r2, d_r2, labels, ndim, big):
    out = torch.full((q_t8.shape[1],), big, dtype=torch.int32,
                     device=q_t8.device)
    big_t = torch.tensor(big, dtype=torch.int32, device=q_t8.device)
    for k, dist2 in _columns(q_t8, d_t8, ndim):
        e = k + dist2.shape[1]
        # max-radius joint: HDBSCAN mutual-reachability linkage
        joint = torch.maximum(q_r2[:, None], d_r2[k:e][None, :])
        cand = torch.where(dist2 <= joint, labels[k:e][None, :], big_t)
        out = torch.minimum(out, cand.amin(dim=1))
    return out


def nearest_plain(q_t8, d_t8, ndim):
    """Per query: the least dist2 and the first data index reaching it,
    (inf, 0) where none is below inf. NaN data lanes are the port's pad
    lanes and never win, one lane at a time, as in the kernel. There the
    Pallas ``tile_nearest`` differs: its ``jnp.min`` over a tile returns
    NaN when one lane is NaN, which drops the tile's other lanes too. The
    JAX package pads with the sentinel, not NaN, so the two agree on every
    cloud without NaN coordinates."""
    n_q = q_t8.shape[1]
    dist = torch.full((n_q,), float("inf"), dtype=torch.float32,
                      device=q_t8.device)
    idx = torch.zeros(n_q, dtype=torch.int32, device=q_t8.device)
    for k, dist2 in _columns(q_t8, d_t8, ndim):
        # a NaN lane is never nearer (as in the kernel's strict <), and
        # takes no other lane of its tile with it (torch.min would)
        dist2.masked_fill_(dist2.isnan(), float("inf"))
        # the first minimum of each tile, and a later tile only when
        # strictly nearer: the lowest index wins ties (argmin)
        best, arg = dist2.min(dim=1)
        take = best < dist
        dist = torch.where(take, best, dist)
        idx = torch.where(take, (arg + k).to(torch.int32), idx)
    return dist, idx


# ---------------------------------------------------------------------------
# the tile decisions of kernels 6-9 and 12, mirrored
# ---------------------------------------------------------------------------

# a CUDA block holds 256 queries, 2 per thread at stride 128: warp w's
# query group is lanes 32w..32w+31 and 128+32w..128+32w+31 of its block;
# a data chunk is 256 consecutive lanes
BLOCK, WARP, GROUPS_PER_BLOCK = 256, 32, 4


def query_groups(n_q: int) -> torch.Tensor:
    """(G, 64) lane indices of each warp's query group, -1 past ``n_q``."""
    n_blocks = -(-n_q // BLOCK)
    idx = torch.arange(n_blocks * BLOCK).view(n_blocks, 2, GROUPS_PER_BLOCK,
                                              WARP)
    idx = idx.permute(0, 2, 1, 3).reshape(n_blocks * GROUPS_PER_BLOCK,
                                          2 * WARP)
    return torch.where(idx < n_q, idx, -1)


def data_chunks(n_d: int) -> torch.Tensor:
    """(C, 256) lane indices of each data chunk, -1 past ``n_d``."""
    idx = torch.arange(-(-n_d // BLOCK) * BLOCK).view(-1, BLOCK)
    return torch.where(idx < n_d, idx, -1)


def _boxes(t8, ndim, lanes, take, r2=None):
    """Per group of ``lanes`` (rows of lane indices, -1 = none): the
    per-coordinate min and max (ndim, G) over the lanes ``take`` keeps,
    their largest ``r2`` (-inf where none) and their count."""
    keep = (lanes >= 0) & take[lanes.clamp(min=0)]
    x = t8[:ndim, lanes.clamp(min=0)]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=t8.device)
    lo = torch.where(keep, x, inf).amin(dim=-1)
    hi = torch.where(keep, x, -inf).amax(dim=-1)
    r2max = (torch.where(keep, r2[lanes.clamp(min=0)], -inf).amax(dim=-1)
             if r2 is not None else None)
    return lo, hi, r2max, keep.sum(dim=-1)


def tile_bounds(q_lo, q_hi, d_lo, d_hi):
    """(L, U) (G, C): every pair of a tile has dist2 in [L, U]. Per
    coordinate the gap G_c = max(0, dmin - qmax, qmin - dmax) and the reach
    D_c = max(qmax - dmin, dmax - qmin), each difference rounded, then
    sum(G_c**2) and sum(D_c**2) in coordinate order, each step rounded on
    its own: rounding is monotone and odd, so |fl(q_c - d_c)| lies in
    [G_c, D_c] and every rounded square and sum keeps the order. The max
    ignores NaN (CUDA's fmaxf)."""
    low = up = None
    zero = torch.zeros((), dtype=torch.float32, device=q_lo.device)
    for c in range(q_lo.shape[0]):
        g = torch.fmax(torch.fmax(d_lo[c][None, :] - q_hi[c][:, None],
                                  q_lo[c][:, None] - d_hi[c][None, :]), zero)
        u = torch.fmax(q_hi[c][:, None] - d_lo[c][None, :],
                       d_hi[c][None, :] - q_lo[c][:, None])
        low = g * g if low is None else low + g * g
        up = u * u if up is None else up + u * u
    return low, up


def lanes_ok(t8, ndim):
    """(N,) lanes whose ndim coordinates are all numbers (not NaN)."""
    return ~torch.isnan(t8[:ndim]).any(dim=0)


def at_sentinel(t8, ndim):
    """(N,) lanes at the sentinel in all ndim coordinates: one point S."""
    return (t8[:ndim] == SENTINEL).all(dim=0)


def nearest_thresholds(q_t8, ndim, q_lanes, q_ok, d_lo, d_hi, s_box=None):
    """Kernel 9's T (G,): per query lane that is a number the least U over
    the chunk boxes (and S's box ``s_box`` (ndim,), where a chunk holds
    sentinel lanes), each lane a box of one point; then per group the
    largest over its lanes (-inf where it has none). Every such lane's
    nearest dist2 is at most T: the chunk that attains its least U holds a
    point at most that far."""
    x = q_t8[:ndim]
    _, up = tile_bounds(x, x, d_lo, d_hi)
    t_lane = up.amin(dim=1)
    if s_box is not None:
        _, up_s = tile_bounds(x, x, s_box[:, None], s_box[:, None])
        t_lane = torch.minimum(t_lane, up_s[:, 0])
    ninf = torch.tensor(float("-inf"), dtype=torch.float32, device=x.device)
    t_lane = torch.where(q_ok, t_lane, ninf)
    return torch.where(q_lanes >= 0, t_lane[q_lanes.clamp(min=0)],
                       ninf).amax(dim=1)


def tile_decisions(q_t8, d_t8, ndim, r2=None, radius2=None, labels=None,
                   big: int = 2 ** 30, levels2=None,
                   nearest: bool = False, d_radius2=None) -> dict:
    """The decisions the box pre-pass of kernels 6-9 and 12 makes, per
    (warp query group, data chunk) tile, in torch on the same boxes and
    bounds.

    Kernels 6 (``r2``) and 7 (``levels2``, any order): per level k a tile
    adds nothing where L > l_k and the chunk's lanes in ``d_count`` to each
    query lane that is a number where U <= l_k; it is ``skip`` where no
    level adds, ``whole`` where every level is decided and one adds
    (``whole_levels`` (G, C, levels) says which add), else ``pairs`` (the
    pair loop, which counts every level). Kernels 8 and 12 (``radius2``
    of the queries, ``d_radius2`` and ``labels`` of the data; kernel 8
    passes one cloud as ``q_t8`` and ``d_t8`` and leaves ``d_radius2``
    None, the data's radii being ``radius2``): the data boxes keep only
    lanes with label < big, and a tile is skipped where L > max(the
    group's largest query radius2, the chunk's largest data radius2),
    else pairs. Kernel 9
    (``nearest``): data lanes at the sentinel S in every coordinate stay
    out of the chunk boxes (``d_sent`` (C,) counts them); each group gets
    the bound ``t`` (G,) of :func:`nearest_thresholds`, and a tile is
    skipped where L > T strictly, and, where its chunk holds sentinel
    lanes, S's own L > T too: every pair left out is then strictly
    farther than its query's nearest, so no minimum and no tie is lost.

    Boxes are over lanes that are numbers in every coordinate; NaN lanes
    never hit. Returns the (G, C) bool ``skip``, ``whole``, ``pairs``, the
    (G, C) uint8 ``codes`` the kernels write on request (0 skip, 1 whole,
    2 pairs), the lane tables ``q_lanes`` (G, 64) and ``d_lanes`` (C, 256)
    (-1 past the end), ``d_count`` (C,) and ``needed_pairs``: the (query
    lane, data lane) pairs inside the tiles left to the pair loop."""
    n_q, n_d = q_t8.shape[1], d_t8.shape[1]
    q_lanes, d_lanes = (query_groups(n_q).to(q_t8.device),
                        data_chunks(n_d).to(q_t8.device))
    q_ok, d_ok = lanes_ok(q_t8, ndim), lanes_ok(d_t8, ndim)
    if labels is not None:
        d_ok = d_ok & (labels < big)
    out = {}
    if nearest:
        d_s = at_sentinel(d_t8, ndim)
        d_ok = d_ok & ~d_s
        out["d_sent"] = (d_s[d_lanes.clamp(min=0)] & (d_lanes >= 0)).sum(dim=1)
    q_lo, q_hi, q_r2, _ = _boxes(q_t8, ndim, q_lanes, q_ok, radius2)
    d_lo, d_hi, d_r2, d_count = _boxes(
        d_t8, ndim, d_lanes, d_ok,
        radius2 if d_radius2 is None else d_radius2)
    low, up = tile_bounds(q_lo, q_hi, d_lo, d_hi)
    whole = None
    if r2 is not None or levels2 is not None:
        lv = torch.as_tensor(r2 if levels2 is None else levels2,
                             dtype=torch.float32, device=q_t8.device).view(-1)
        adds_none = low[..., None] > lv
        adds_all = up[..., None] <= lv
        skip = adds_none.all(dim=-1)
        whole = ~skip & (adds_none | adds_all).all(dim=-1)
        out["whole_levels"] = whole[..., None] & adds_all
    elif nearest:
        s = torch.full((ndim,), SENTINEL, dtype=torch.float32,
                       device=q_t8.device)
        has_s = out["d_sent"] > 0
        t = nearest_thresholds(q_t8, ndim, q_lanes, q_ok, d_lo, d_hi,
                               s if bool(has_s.any()) else None)
        low_s, _ = tile_bounds(q_lo, q_hi, s[:, None], s[:, None])
        skip = (low > t[:, None]) & (~has_s[None, :] | (low_s > t[:, None]))
        out["t"] = t
    else:
        skip = low > torch.fmax(q_r2[:, None], d_r2[None, :])
    if whole is None:
        whole = torch.zeros_like(skip)
    pairs = ~skip & ~whole
    needed = (pairs.to(torch.int64) * (q_lanes >= 0).sum(dim=1)[:, None]
              * (d_lanes >= 0).sum(dim=1)[None, :]).sum()
    codes = whole.to(torch.uint8) + 2 * pairs.to(torch.uint8)
    return {"skip": skip, "whole": whole, "pairs": pairs, "codes": codes,
            "q_lanes": q_lanes, "d_lanes": d_lanes, "d_count": d_count,
            "needed_pairs": int(needed), **out}


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# -fmad=false: every product and sum rounds on its own, as the plain
# versions' separate ops do
LIBRARY = CudaLibrary("dense.cu", {
    # q, nq, d, nd, ndim, r2, levels2 (null: the one level r2), boxes, out,
    # tiles, stream
    "dense_count": (_P, _I, _P, _I, _I, _F, _P, _P, _P, _P, _P),
    # q, nq, q_r2, d, nd, d_r2, labels, ndim, big, boxes, out, tiles,
    # stream (kernel 8: one cloud as q and d)
    "dense_min_label": (_P, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P),
    # q, nq, d, nd, ndim, sentinel, boxes, keys, dist, idx, tiles, stream
    "dense_nearest": (_P, _I, _P, _I, _I, _F, _P, _P, _P, _P, _P, _P),
}, extra_flags=("-fmad=false",))

# kernels 6-9 and 12: a box is 16 floats of the wrapper's scratch
_BOX_FLOATS = 16


def pad_lanes(t, n: int, value):
    """``t`` (..., N) widened to ``n`` lanes, the new ones set to ``value``:
    kernels 6-9 and 12 copy data rows 16 bytes at a time, so their wrappers
    pad a cloud to a multiple of 4 lanes, with NaN coordinates (every
    compare with a NaN lane is false, and the boxes leave it out), radius
    0 and label big."""
    out = torch.full((*t.shape[:-1], n), value, dtype=t.dtype,
                     device=t.device)
    out[..., :t.shape[-1]] = t
    return out


def _copy16(*tensors) -> bool:
    """True when rows of the lane count of ``tensors[0]`` can be staged by
    16-byte copies: a multiple of 4 lanes, every base 16-byte aligned."""
    return (tensors[0].shape[-1] % 4 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def _box_scratch(n_q, n_d, device):
    """Scratch for the box pre-pass: 4 warp query groups per 256 queries,
    one box per 256-lane data chunk."""
    n_boxes = 4 * -(-n_q // BLOCK) + -(-n_d // BLOCK)
    return torch.empty(n_boxes * _BOX_FLOATS, dtype=torch.float32,
                       device=device)


def _tiles_ptr(name, tiles, q_t8, n_q, n_d) -> int:
    """The address the kernel writes its tile decisions to (0: none):
    ``tiles`` must be a contiguous (4 ceil(n_q / 256), ceil(n_d / 256))
    uint8 tensor beside the CUDA cloud."""
    if tiles is None:
        return 0
    shape = (GROUPS_PER_BLOCK * -(-n_q // BLOCK), -(-n_d // BLOCK))
    if (not q_t8.is_cuda or tiles.device != q_t8.device
            or tiles.dtype != torch.uint8 or tuple(tiles.shape) != shape
            or not tiles.is_contiguous()):
        raise ValueError(f"{name}: tiles must be a contiguous {shape} uint8 "
                         f"tensor on the CUDA cloud's device, got "
                         f"{tuple(tiles.shape)} {tiles.dtype} on "
                         f"{tiles.device} (cloud on {q_t8.device})")
    return tiles.data_ptr()


def _check_clouds(name, q_t8, d_t8, ndim):
    for arg, t in (("query", q_t8), ("data", d_t8)):
        if t.dim() != 2 or t.shape[0] != 8 or t.shape[1] == 0:
            raise ValueError(f"{name}: {arg} points must be (8, N > 0), got "
                             f"{tuple(t.shape)}")
    if ndim not in (3, 4, 5, 6):
        raise ValueError(f"{name}: ndim {ndim} not in (3, 4, 5, 6)")
    if q_t8.shape[1] >= 2 ** 31 or d_t8.shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: more than 2**31 points")


def _launch(name, fn, *args):
    launch(fn, *args)
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _count(name, q_t8, d_t8, ndim, r2, levels2, tiles, plain):
    """Kernels 6 (``levels2`` None: the one level ``r2``) and 7 (the three
    ``levels2``) through ``dense_count`` -> (Nq,) or (Nq, 3) int32."""
    n_q, n_d = q_t8.shape[1], d_t8.shape[1]
    tiles_ptr = _tiles_ptr(name, tiles, q_t8, n_q, n_d)
    if not q_t8.is_cuda:
        return plain()
    if not _copy16(d_t8):
        d_t8 = pad_lanes(d_t8, -(-n_d // 4) * 4, float("nan"))
    boxes = _box_scratch(n_q, d_t8.shape[1], q_t8.device)
    shape = (n_q,) if levels2 is None else (n_q, 3)
    out = torch.empty(shape, dtype=torch.int32, device=q_t8.device)
    with torch.cuda.device(q_t8.device):
        _launch(name, LIBRARY.load().dense_count, q_t8.data_ptr(), n_q,
                d_t8.data_ptr(), d_t8.shape[1], ndim, float(r2),
                0 if levels2 is None else levels2.data_ptr(),
                boxes.data_ptr(), out.data_ptr(), tiles_ptr,
                stream_of(q_t8.device))
    return out


def tile_radius_count(q_t8, d_t8, r2: float, ndim: int = 3, *,
                      tiles=None) -> torch.Tensor:
    """Per query: data points with squared distance <= ``r2`` (self
    included) -> (Nq,) int32. Replaces ``pallas_kernels.tile_radius_count``.
    On the card, ``tiles`` (a (G, C) uint8 tensor, see
    :func:`tile_decisions`) receives the kernel's decision per tile."""
    name = "tile_radius_count"
    _check_clouds(name, q_t8, d_t8, ndim)
    _check(name, {"q_t8": q_t8, "d_t8": d_t8},
           (torch.float32, torch.float32), q_t8.device)
    return _count(name, q_t8, d_t8, ndim, r2, None, tiles,
                  lambda: count_plain(q_t8, d_t8, r2, ndim))


def tile_radius_count3(q_t8, d_t8, levels2, ndim: int = 3, *,
                       tiles=None) -> torch.Tensor:
    """Counts at three squared radii ``levels2`` (3,) f32 (in any order)
    -> (Nq, 3) int32. Replaces ``pallas_kernels.tile_radius_count3``. On
    the card, ``tiles`` (a (G, C) uint8 tensor, see
    :func:`tile_decisions`) receives the kernel's decision per tile."""
    name = "tile_radius_count3"
    _check_clouds(name, q_t8, d_t8, ndim)
    _check(name, {"q_t8": q_t8, "d_t8": d_t8, "levels2": levels2},
           (torch.float32, torch.float32, torch.float32), q_t8.device)
    if levels2.shape != (3,):
        raise ValueError(f"{name}: levels2 must be (3,), got "
                         f"{tuple(levels2.shape)}")
    return _count(name, q_t8, d_t8, ndim, 0.0, levels2, tiles,
                  lambda: count3_plain(q_t8, d_t8, levels2, ndim))


def _min_label(name, q_t8, q_r2, d_t8, d_r2, labels, ndim, big, tiles_ptr):
    """Kernels 8 and 12 through ``dense_min_label`` on CUDA clouds ->
    (Nq,) int32; data padded with NaN lanes (radius 0, label big) to a
    multiple of 4 where its rows cannot be staged by 16-byte copies."""
    n_q, n_d = q_t8.shape[1], d_t8.shape[1]
    if not _copy16(d_t8, d_r2, labels):
        n4 = -(-n_d // 4) * 4
        d_t8 = pad_lanes(d_t8, n4, float("nan"))
        d_r2, labels = pad_lanes(d_r2, n4, 0.0), pad_lanes(labels, n4, big)
    boxes = _box_scratch(n_q, d_t8.shape[1], q_t8.device)
    out = torch.empty(n_q, dtype=torch.int32, device=q_t8.device)
    with torch.cuda.device(q_t8.device):
        _launch(name, LIBRARY.load().dense_min_label, q_t8.data_ptr(), n_q,
                q_r2.data_ptr(), d_t8.data_ptr(), d_t8.shape[1],
                d_r2.data_ptr(), labels.data_ptr(), ndim, int(big),
                boxes.data_ptr(), out.data_ptr(), tiles_ptr,
                stream_of(q_t8.device))
    return out


def tile_min_label(pts_t8, radius2, labels, ndim: int, big: int = 2 ** 30,
                   *, tiles=None):
    """Per point: the minimum label over points within max(radius2_q,
    radius2_d), else ``big`` -> (N,) int32. Points that take no part carry
    sentinel coordinates, radius 0 and a label >= ``big``. Replaces
    ``pallas_kernels.tile_min_label`` (which carries the labels as f32,
    exact below 2**24). On the card, ``tiles`` (a (G, C) uint8 tensor, see
    :func:`tile_decisions`) receives the kernel's decision per tile."""
    name = "tile_min_label"
    n = pts_t8.shape[1]
    _check_clouds(name, pts_t8, pts_t8, ndim)
    _check(name, {"pts_t8": pts_t8, "radius2": radius2, "labels": labels},
           (torch.float32, torch.float32, torch.int32), pts_t8.device)
    if radius2.shape != (n,) or labels.shape != (n,):
        raise ValueError(f"{name}: radius2 and labels must be ({n},)")
    tiles_ptr = _tiles_ptr(name, tiles, pts_t8, n, n)
    if not pts_t8.is_cuda:
        return min_label_plain(pts_t8, radius2, labels, ndim, big)
    return _min_label(name, pts_t8, radius2, pts_t8, radius2, labels, ndim,
                      big, tiles_ptr)


def tile_min_label_qd(q_t8, d_t8, q_r2, d_r2, labels, ndim: int,
                      big: int = 2 ** 30, *, tiles=None):
    """Per query: the minimum label over DATA points within max(q_r2,
    d_r2), else ``big`` -> (Nq,) int32; query and data are different clouds
    (a query block and a data window of the sorted core cloud), ``labels``
    are the data's. Lanes that take no part carry sentinel coordinates,
    radius 0 and a label >= ``big``. Replaces
    ``pallas_kernels.tile_min_label_qd``, which returns the same values as
    f32 (labels carried as f32, exact below 2**24) and covers only query
    counts <= 512 or multiples of 512 and data counts in multiples of 2048;
    this wrapper takes any sizes. On the card, ``tiles`` (a (G, C) uint8
    tensor, see :func:`tile_decisions`) receives the kernel's decision per
    tile."""
    name = "tile_min_label_qd"
    _check_clouds(name, q_t8, d_t8, ndim)
    _check(name, {"q_t8": q_t8, "d_t8": d_t8, "q_r2": q_r2, "d_r2": d_r2,
                  "labels": labels},
           (torch.float32,) * 4 + (torch.int32,), q_t8.device)
    n_q, n_d = q_t8.shape[1], d_t8.shape[1]
    if q_r2.shape != (n_q,) or d_r2.shape != (n_d,) or labels.shape != (n_d,):
        raise ValueError(f"{name}: q_r2 must be ({n_q},), d_r2 and labels "
                         f"({n_d},)")
    tiles_ptr = _tiles_ptr(name, tiles, q_t8, n_q, n_d)
    if not q_t8.is_cuda:
        return min_label_qd_plain(q_t8, d_t8, q_r2, d_r2, labels, ndim, big)
    return _min_label(name, q_t8, q_r2, d_t8, d_r2, labels, ndim, big,
                      tiles_ptr)


def tile_nearest(q_t8, d_t8, ndim: int = 3, *, tiles=None):
    """Per query: the nearest data point -> (dist2 (Nq,) f32, data index
    (Nq,) int32); the lowest index wins ties, and a query with no dist2
    below inf gets (inf, 0). Replaces ``pallas_kernels.tile_nearest``. On
    the card, ``tiles`` (a (G, C) uint8 tensor, see
    :func:`tile_decisions`) receives the kernel's decision per tile."""
    name = "tile_nearest"
    _check_clouds(name, q_t8, d_t8, ndim)
    _check(name, {"q_t8": q_t8, "d_t8": d_t8},
           (torch.float32, torch.float32), q_t8.device)
    n_q, n_d = q_t8.shape[1], d_t8.shape[1]
    tiles_ptr = _tiles_ptr(name, tiles, q_t8, n_q, n_d)
    if not q_t8.is_cuda:
        return nearest_plain(q_t8, d_t8, ndim)
    if not _copy16(d_t8):
        # NaN lanes past the end never win, so no index moves
        d_t8 = pad_lanes(d_t8, -(-n_d // 4) * 4, float("nan"))
    boxes = _box_scratch(n_q, d_t8.shape[1], q_t8.device)
    # 64-bit (bits(dist2) << 32 | index) merge keys, set by the kernel
    keys = torch.empty(n_q, dtype=torch.int64, device=q_t8.device)
    dist = torch.empty(n_q, dtype=torch.float32, device=q_t8.device)
    idx = torch.empty(n_q, dtype=torch.int32, device=q_t8.device)
    with torch.cuda.device(q_t8.device):
        _launch(name, LIBRARY.load().dense_nearest, q_t8.data_ptr(), n_q,
                d_t8.data_ptr(), d_t8.shape[1], ndim, SENTINEL,
                boxes.data_ptr(), keys.data_ptr(), dist.data_ptr(),
                idx.data_ptr(), tiles_ptr, stream_of(q_t8.device))
    return dist, idx


PLAIN = {
    "tile_radius_count": count_plain,
    "tile_radius_count3": count3_plain,
    "tile_min_label": min_label_plain,
    "tile_nearest": nearest_plain,
    "tile_min_label_qd": min_label_qd_plain,
}
