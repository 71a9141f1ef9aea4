"""Patchwork++-style ground segmentation; the port of
``vilgod_tpu/ground/patchwork.py`` (the single-device scans).

The algorithm is the JAX package's (see its module docstring): RNR noise
removal, the Concentric Zone Model over 504 patches, per-patch z-sorted
tables with R-VPF vertical-plane removal and R-GPF iterative PCA, GLE
gating, TGR temporal revert, and the A-GLE adaptive state carried from
frame to frame. All patches run as one batch (the JAX package's vmap);
the frame scan is a Python loop that carries the :class:`GroundState`,
after one batched presort of every frame. The chained scan
(:func:`segment_sequence_chained`) runs k chunks of frames side by side,
each step one batch of k frames with k states. On a CUDA device the step
is captured once as a CUDA graph and replayed frame by frame
(:class:`_StepGraph`): the same kernels in the same order, launched by one
replay instead of some 300 calls from Python.

Float sums over many terms (patch means and covariances, ring
statistics) accumulate in float64 and round to float32 once: the result
then hardly depends on the summation order. Dot products of 3-vectors are
written out in a fixed order for the same reason. A CUDA run and a CPU run
of the port still differ in the patches' flatness (the smallest
eigenvalue, from ``acos`` and ``cos``, whose last bits differ between the
two), by up to ~1e-3 relative, and so in the flatness thresholds; on the
tests' scenes their masks are equal.
"""
from __future__ import annotations

import functools
import math
import threading
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..ops.plane import _cross, _dot3
from ..utils import trace


class GroundConfig(NamedTuple):
    """Static algorithm parameters. Defaults mirror Patchwork++'s with the
    pipeline's min_range override."""
    enable_rnr: bool = True
    enable_rvpf: bool = True
    enable_tgr: bool = True
    num_iter: int = 3
    num_lpr: int = 20
    num_min_pts: int = 10
    num_rings_of_interest: int = 4
    rnr_ver_angle_thr: float = -15.0
    rnr_intensity_thr: float = 0.2
    sensor_height: float = 1.723
    th_seeds: float = 0.125
    th_dist: float = 0.125
    th_seeds_v: float = 0.25
    th_dist_v: float = 0.1
    max_range: float = 80.0
    min_range: float = 1.5
    uprightness_thr: float = 0.707
    adaptive_seed_selection_margin: float = -1.2
    num_sectors_each_zone: tuple = (16, 32, 54, 32)
    num_rings_each_zone: tuple = (2, 4, 4, 4)
    max_storage: int = 1000
    patch_capacity: int = 1024


def ground_config_from_cfg(cfg, **overrides) -> GroundConfig:
    """Build from the ``preprocessor.ground`` config subtree."""
    g = cfg.preprocessor.ground
    kw = dict(
        enable_rnr=g.enable_rnr, enable_rvpf=g.enable_rvpf,
        enable_tgr=g.enable_tgr, num_iter=g.num_iter, num_lpr=g.num_lpr,
        num_min_pts=g.num_min_pts,
        num_rings_of_interest=g.num_rings_of_interest,
        rnr_ver_angle_thr=g.rnr_ver_angle_thr,
        rnr_intensity_thr=g.rnr_intensity_thr,
        sensor_height=g.sensor_height, th_seeds=g.th_seeds,
        th_dist=g.th_dist, th_seeds_v=g.th_seeds_v, th_dist_v=g.th_dist_v,
        max_range=g.max_range, min_range=g.min_range,
        uprightness_thr=g.uprightness_thr,
        adaptive_seed_selection_margin=g.adaptive_seed_selection_margin,
        num_sectors_each_zone=tuple(g.num_sectors_each_zone),
        num_rings_each_zone=tuple(g.num_rings_each_zone),
        max_storage=g.max_storage,
        patch_capacity=cfg.capacity.patch_capacity,
    )
    kw.update(overrides)
    return GroundConfig(**kw)


class GroundState(NamedTuple):
    """A-GLE / TGR adaptive state carried across frames."""
    sensor_height: torch.Tensor       # () f32
    elevation_thr: torch.Tensor       # (R,) R = num_rings_of_interest
    flatness_thr: torch.Tensor        # (R,)
    elev_buf: torch.Tensor            # (R, S)
    elev_cnt: torch.Tensor            # (R,) int32
    elev_ptr: torch.Tensor            # (R,) int32
    flat_buf: torch.Tensor            # (R, S)
    flat_cnt: torch.Tensor            # (R,)
    flat_ptr: torch.Tensor            # (R,)


def init_ground_state(cfg: GroundConfig, device=None) -> GroundState:
    r, s = cfg.num_rings_of_interest, cfg.max_storage
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return GroundState(
        sensor_height=torch.full((), cfg.sensor_height, **f32),
        elevation_thr=torch.zeros(r, **f32), flatness_thr=torch.zeros(r, **f32),
        elev_buf=torch.zeros((r, s), **f32), elev_cnt=torch.zeros(r, **i32),
        elev_ptr=torch.zeros(r, **i32),
        flat_buf=torch.zeros((r, s), **f32), flat_cnt=torch.zeros(r, **i32),
        flat_ptr=torch.zeros(r, **i32),
    )


# ---------------------------------------------------------------------------
# CZM geometry (static numpy precomputation)
# ---------------------------------------------------------------------------

def _czm_geometry(cfg: GroundConfig):
    nz = len(cfg.num_rings_each_zone)
    min_r, max_r = cfg.min_range, cfg.max_range
    min_ranges = [
        min_r,
        (7 * min_r + max_r) / 8.0,
        (3 * min_r + max_r) / 4.0,
        (min_r + max_r) / 2.0,
    ]
    ring_sizes = [
        (min_ranges[1] - min_ranges[0]) / cfg.num_rings_each_zone[0],
        (min_ranges[2] - min_ranges[1]) / cfg.num_rings_each_zone[1],
        (min_ranges[3] - min_ranges[2]) / cfg.num_rings_each_zone[2],
        (max_r - min_ranges[3]) / cfg.num_rings_each_zone[3],
    ]
    sector_sizes = [2 * math.pi / n for n in cfg.num_sectors_each_zone]

    patch_zone, patch_conc = [], []
    conc = 0
    for z in range(nz):
        for _ in range(cfg.num_rings_each_zone[z]):
            for _ in range(cfg.num_sectors_each_zone[z]):
                patch_zone.append(z)
                patch_conc.append(conc)
            conc += 1
    return (
        np.asarray(min_ranges, np.float32),
        np.asarray(ring_sizes, np.float32),
        np.asarray(sector_sizes, np.float32),
        np.asarray(patch_zone, np.int32),
        np.asarray(patch_conc, np.int32),
    )


def _num_patches(cfg: GroundConfig) -> int:
    return int(sum(r * s for r, s in
                   zip(cfg.num_rings_each_zone, cfg.num_sectors_each_zone)))


class _CZMTables(NamedTuple):
    """The CZM's per-zone tables on a device (:func:`_czm_tables`)."""
    boundaries: torch.Tensor      # (4,) f32, each zone's outer edge
    min_ranges: torch.Tensor      # (4,) f32
    ring_sizes: torch.Tensor      # (4,) f32
    sector_sizes: torch.Tensor    # (4,) f32
    num_rings: torch.Tensor       # (4,) int32
    num_sectors: torch.Tensor     # (4,) int32
    zone_offsets: torch.Tensor    # (4,) int32, each zone's first patch id


@functools.lru_cache(maxsize=16)
def _czm_tables(cfg: GroundConfig, device: torch.device) -> _CZMTables:
    """:func:`_czm_geometry`'s zone tables, uploaded once per config and
    device; callers only read them."""
    min_ranges, ring_sizes, sector_sizes, _, _ = _czm_geometry(cfg)
    nz = len(cfg.num_rings_each_zone)
    zone_offsets = np.concatenate(
        [[0], np.cumsum([r * s for r, s in zip(cfg.num_rings_each_zone,
                                               cfg.num_sectors_each_zone)])]
    )[:nz].astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return _CZMTables(
        t(np.concatenate([min_ranges[1:], [cfg.max_range]]).astype(np.float32)),
        t(min_ranges), t(ring_sizes), t(sector_sizes),
        t(np.asarray(cfg.num_rings_each_zone, np.int32)),
        t(np.asarray(cfg.num_sectors_each_zone, np.int32)), t(zone_offsets))


class _StepConsts(NamedTuple):
    """What one scan step reads besides its frames and state, for k chains
    (patch arrays chain-major over k x patches): built once per config,
    device and k (:func:`_step_consts`), so that the step makes no upload
    and no host sync."""
    patch_zone: torch.Tensor      # (k x patches,) int32
    patch_conc: torch.Tensor      # (k x patches,) int32, concentric ring
    chain_of_patch: torch.Tensor  # (k x patches,) int64
    chain: torch.Tensor           # (k,) int64
    patch_off: torch.Tensor       # (k, 1) int32, each chain's first patch
    mult: torch.Tensor            # (R,) f32, A-GLE's elevation multipliers


@functools.lru_cache(maxsize=16)
def _step_consts(cfg: GroundConfig, device: torch.device, k: int
                 ) -> _StepConsts:
    """The step's constants on ``device``, cached; callers only read them."""
    _, _, _, patch_zone_np, patch_conc_np = _czm_geometry(cfg)
    num_patches = _num_patches(cfg)
    chain = torch.arange(k, device=device)
    mult = np.full(cfg.num_rings_of_interest, 2.0, np.float32)
    mult[0] = 3.0
    return _StepConsts(
        patch_zone=torch.from_numpy(patch_zone_np).to(device).repeat(k),
        patch_conc=torch.from_numpy(patch_conc_np).to(device).repeat(k),
        chain_of_patch=chain.repeat_interleave(num_patches),
        chain=chain,
        patch_off=(chain.to(torch.int32) * num_patches)[:, None],
        mult=torch.from_numpy(mult).to(device))


def _point_patch_ids(xyz: torch.Tensor, cfg: GroundConfig) -> torch.Tensor:
    """Per-point patch id, -1 for out-of-range points."""
    czm = _czm_tables(cfg, xyz.device)
    x, y = xyz[:, 0], xyz[:, 1]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x)
    theta = torch.where(theta > 0, theta, 2 * math.pi + theta)

    zone = (r[:, None] >= czm.boundaries[None, :3]).sum(dim=1)  # 0..3

    min_r_z = czm.min_ranges[zone]
    ring_sz = czm.ring_sizes[zone]
    sec_sz = czm.sector_sizes[zone]
    n_rings = czm.num_rings[zone]
    n_secs = czm.num_sectors[zone]

    ring = torch.minimum(((r - min_r_z) / ring_sz).to(torch.int32), n_rings - 1)
    sec = torch.minimum((theta / sec_sz).to(torch.int32), n_secs - 1)
    patch = czm.zone_offsets[zone] + ring * n_secs + sec
    in_range = (r > cfg.min_range) & (r <= cfg.max_range)
    return torch.where(in_range, patch, -1)


# ---------------------------------------------------------------------------
# per-patch plane machinery, batched over patches (leading axis P)
# ---------------------------------------------------------------------------

def _sum64(x: torch.Tensor, dim) -> torch.Tensor:
    """Order-independent f32 sum: accumulate in f64, round once."""
    return x.to(torch.float64).sum(dim=dim).to(torch.float32)


def _eigh3_smallest(a: torch.Tensor):
    """Closed-form symmetric 3x3 eigendecomposition of a (P, 3, 3) batch:
    eigenvalues ascending (P, 3) and the unit eigenvector of the smallest
    one (P, 3). Trigonometric method plus cross-product eigenvector;
    degenerate spectra fall back to +z (the identity's last row), as in
    the JAX package."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    trace = a[:, 0, 0] + a[:, 1, 1] + a[:, 2, 2]
    q = trace / 3.0
    a_q = a - q[:, None, None] * eye
    sq = (a_q * a_q).reshape(-1, 9)
    ss = sq[:, 0]
    for k in range(1, 9):
        ss = ss + sq[:, k]
    p = torch.sqrt(torch.clamp(ss / 6.0, min=0.0))
    b = a_q / torch.clamp(p, min=1e-20)[:, None, None]
    det = (b[:, 0, 0] * b[:, 1, 1] * b[:, 2, 2]
           + b[:, 0, 1] * b[:, 1, 2] * b[:, 2, 0]
           + b[:, 0, 2] * b[:, 1, 0] * b[:, 2, 1]
           - b[:, 0, 2] * b[:, 1, 1] * b[:, 2, 0]
           - b[:, 0, 0] * b[:, 1, 2] * b[:, 2, 1]
           - b[:, 0, 1] * b[:, 1, 0] * b[:, 2, 2])
    r = torch.clamp(det / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    evals = torch.stack([e_lo, e_mid, e_hi], dim=1)

    m = a - e_lo[:, None, None] * eye
    cands = torch.stack([_cross(m[:, 0], m[:, 1]), _cross(m[:, 0], m[:, 2]),
                         _cross(m[:, 1], m[:, 2])], dim=1)       # (P, 3, 3)
    norms = _dot3(cands, cands)                                   # (P, 3)
    pick = torch.argmax(norms, dim=1)
    v = cands[torch.arange(a.shape[0], device=a.device), pick]
    vn = torch.sqrt(_dot3(v, v))
    up = eye[2]
    scale = torch.clamp(trace, min=1e-20)
    distinct = (e_mid - e_lo) > 1e-6 * scale
    ok = (p > 1e-12 * scale) & (vn > 1e-12) & distinct
    v = torch.where(ok[:, None], v / torch.clamp(vn, min=1e-20)[:, None], up)
    return evals, v


def _pca_plane(pts: torch.Tensor, sel: torch.Tensor):
    """Masked PCA plane per patch: pts (P, cap, 3), sel (P, cap) ->
    (normal (P, 3) with +z, mean (P, 3), d (P,), eigenvalues (P, 3)
    ascending, count (P,))."""
    cnt = sel.sum(dim=1, dtype=torch.int32)
    n = torch.clamp(cnt, min=1)
    mean = _sum64(torch.where(sel[..., None], pts, 0.0), 1) / n[:, None]
    centered = torch.where(sel[..., None], pts - mean[:, None, :], 0.0)
    c64 = centered.to(torch.float64)
    cov = torch.einsum("pki,pkj->pij", c64, c64).to(torch.float32)
    cov = cov / torch.clamp(n - 1, min=1)[:, None, None]
    eigvals, normal = _eigh3_smallest(cov)
    normal = torch.where(normal[:, 2:3] < 0, -normal, normal)
    d = _dot3(-normal, mean)
    return normal, mean, d, torch.clamp(eigvals, min=0.0), cnt


def _plane_dist(pts, normal, d):
    """Signed distance of (P, cap, 3) points to their patch plane."""
    return _dot3(pts, normal[:, None, :]) + d[:, None]


def _select_seeds(z, active, is_zone0, th_seed, sensor_height,
                  cfg: GroundConfig):
    """Seed selection over z-sorted patch points (batched); the sensor
    height is one per patch (P,), or one for all."""
    margin = cfg.adaptive_seed_selection_margin * sensor_height
    skip = is_zone0[:, None] & (z < margin.reshape(-1, 1))
    cand = active & ~skip
    rank = torch.cumsum(cand.to(torch.int32), dim=1)
    lpr_sel = cand & (rank <= cfg.num_lpr)
    cnt = lpr_sel.sum(dim=1, dtype=torch.int32)
    lpr = _sum64(torch.where(lpr_sel, z, 0.0), 1) / torch.clamp(cnt, min=1)
    lpr = torch.where(cnt > 0, lpr, 0.0)
    return active & (z < lpr[:, None] + th_seed)


def _extract_piecewise(pts, valid, is_zone0, sensor_height,
                       cfg: GroundConfig):
    """R-VPF + R-GPF for every patch at once. pts (P, cap, 3) z-sorted
    ascending per patch, each patch's sensor height (P,); returns
    (ground_sel, removed_vertical, normal, mean, d, eigvals, n_ground)."""
    z = pts[..., 2]
    removed = torch.zeros_like(valid)
    if cfg.enable_rvpf:
        stop = torch.zeros(valid.shape[0], dtype=torch.bool, device=valid.device)
        for _ in range(cfg.num_iter):
            active = valid & ~removed
            seeds = _select_seeds(z, active, is_zone0, cfg.th_seeds_v,
                                  sensor_height, cfg)
            normal, _, d, _, cnt = _pca_plane(pts, seeds)
            is_vertical = (is_zone0 & (normal[:, 2] < cfg.uprightness_thr)
                           & ~stop & (cnt > 0))
            dist = _plane_dist(pts, normal, d)
            rm = is_vertical[:, None] & (torch.abs(dist) < cfg.th_dist_v) & active
            removed = removed | rm
            stop = stop | ~is_vertical

    active = valid & ~removed
    seeds = _select_seeds(z, active, is_zone0, cfg.th_seeds, sensor_height,
                          cfg)
    normal, mean, d, eig, _ = _pca_plane(pts, seeds)
    for _ in range(cfg.num_iter):
        ground = active & (_plane_dist(pts, normal, d) < cfg.th_dist)
        n2, m2, d2, e2, cnt2 = _pca_plane(pts, ground)
        # empty ground keeps the previous plane
        keep = cnt2 > 0
        normal = torch.where(keep[:, None], n2, normal)
        mean = torch.where(keep[:, None], m2, mean)
        d = torch.where(keep, d2, d)
        eig = torch.where(keep[:, None], e2, eig)
    ground = active & (_plane_dist(pts, normal, d) < cfg.th_dist)
    return ground, removed, normal, mean, d, eig, ground.sum(dim=1)


# ---------------------------------------------------------------------------
# per-frame passes, batched over a leading chain axis
# ---------------------------------------------------------------------------

def _presort_frames(points: torch.Tensor, mask: torch.Tensor,
                    cfg: GroundConfig):
    """State-free patch ordering of a batch of frames, points (F, N, C),
    mask (F, N): per-point patch ids (F, N), the sorted keys and the
    (pid, z, index)-lexicographic order (F, N) (stable sorts, least
    significant key first), each patch's first sorted position (F,
    patches) and the sorted clouds (F, N, 3). One batched sort over every
    frame, as the JAX package's ``segment_sequence`` presorts."""
    f, n = mask.shape
    num_patches = _num_patches(cfg)
    xyz = points[..., :3]
    pid_geo = _point_patch_ids(xyz.reshape(-1, 3), cfg).reshape(f, n)
    key = torch.where(mask & (pid_geo >= 0), pid_geo,
                      num_patches).to(torch.int32)
    by_z = torch.argsort(xyz[..., 2], dim=1, stable=True)
    order = torch.gather(by_z, 1, torch.argsort(
        torch.gather(key, 1, by_z), dim=1, stable=True))
    sorted_key = torch.gather(key, 1, order)
    patches = torch.arange(num_patches, dtype=torch.int32,
                           device=points.device).repeat(f, 1)
    starts = torch.searchsorted(sorted_key, patches).to(torch.int32)
    xyz_sorted = torch.gather(xyz, 1, order[..., None].expand(f, n, 3))
    return pid_geo, sorted_key, order, starts, xyz_sorted


def _segment_presorted(points, mask, state: GroundState, cfg: GroundConfig,
                       pid_geo, sorted_key, order, starts, xyz_sorted,
                       consts: _StepConsts):
    """State-dependent part of the segmentation of k presorted frames, one
    per chain: points (k, N, C), mask (k, N), ``state`` with a leading
    chain axis (``_stack_states``), the presort of :func:`_presort_frames`
    for these k frames, and :func:`_step_consts` for k. The k frames'
    patches run as one batch of k x patches. No upload, no host sync and
    no data-dependent shape, so a CUDA graph can capture it. Returns
    (ground (k, N) bool, new_state, aux): aux holds the per-patch
    ``patch_ground``, ``normals``, ``means`` and ``n_ground`` (k x
    patches, chain-major) and the per-point RNR ``noise`` (k, N)."""
    k, n = mask.shape
    dev = points.device
    num_patches = _num_patches(cfg)
    kp, kn = k * num_patches, k * n
    cap = cfg.patch_capacity
    patch_zone, patch_conc = consts.patch_zone, consts.patch_conc
    chain_of_patch, patch_off = consts.chain_of_patch, consts.patch_off
    pt_off = (consts.chain * n)[:, None]

    xyz = points[..., :3]
    intensity = (points[..., 3] if points.shape[-1] > 3
                 else torch.zeros((k, n), dtype=points.dtype, device=dev))

    # ---- RNR ----
    if cfg.enable_rnr:
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        r = torch.sqrt(x * x + y * y)
        ver_angle = torch.atan2(z, r) * (180.0 / math.pi)
        noise = ((ver_angle < cfg.rnr_ver_angle_thr)
                 & (z < -state.sensor_height[:, None] - 0.8)
                 & (intensity < cfg.rnr_intensity_thr))
    else:
        noise = torch.zeros((k, n), dtype=torch.bool, device=dev)

    usable = mask & ~noise
    patch_ids = torch.where(usable, pid_geo, -1)
    # patch ids over the chains' patches (chain-major), -1 unusable
    gpid = torch.where(patch_ids >= 0, patch_ids + patch_off, -1)

    # ---- z-sorted per-patch tables from the presorted runs, the k frames
    # end to end: rank among the non-noise entries of each patch is the
    # table position ----
    valid_key = sorted_key < num_patches
    nz = (valid_key & ~torch.gather(noise, 1, order)).reshape(-1)
    gkey = torch.where(valid_key, sorted_key + patch_off, kp).reshape(-1)
    gstarts = (starts + pt_off).reshape(-1)
    cum = torch.cumsum(nz.to(torch.int32), 0, dtype=torch.int32)
    start_of = gstarts[torch.clamp(gkey, max=kp - 1).long()]
    cum_before = torch.where(start_of > 0,
                             cum[torch.clamp(start_of - 1, min=0).long()], 0)
    pos = cum - 1 - cum_before
    in_table = nz & (pos < cap)
    flat = torch.where(in_table, gkey * cap + pos, kp * cap).long()
    idx_tab = torch.full((kp * cap + 1,), kn, dtype=torch.int32, device=dev)
    idx_tab[flat] = torch.where(
        in_table, torch.arange(kn, dtype=torch.int32, device=dev), kn)
    idx_tab = idx_tab[: kp * cap]
    tab_ok = idx_tab < kn
    patch_pts = torch.where(
        tab_ok[:, None],
        xyz_sorted.reshape(kn, 3)[torch.clamp(idx_tab, max=kn - 1).long()],
        0.0).reshape(kp, cap, 3)
    table_mask = tab_ok.reshape(kp, cap)

    patch_n_pts = torch.zeros(kp, dtype=torch.int32, device=dev)
    patch_n_pts.index_add_(0, torch.clamp(gpid, min=0).reshape(-1).long(),
                           (gpid >= 0).reshape(-1).to(torch.int32))

    # ---- per-patch piecewise ground extraction ----
    is_zone0 = patch_zone == 0
    ground_sel, _, normals, means, ds, eigs, n_ground = _extract_piecewise(
        patch_pts, table_mask, is_zone0, state.sensor_height[chain_of_patch],
        cfg)

    # ---- GLE gating ----
    enough = patch_n_pts >= cfg.num_min_pts
    uprightness = normals[:, 2]
    elevation = means[:, 2]
    flatness = eigs[:, 0]
    line_variable = torch.where(
        eigs[:, 1] > 0, eigs[:, 2] / torch.clamp(eigs[:, 1], min=1e-12),
        1e12)
    heading = _dot3(means, normals)

    near = patch_conc < cfg.num_rings_of_interest
    conc_clamped = torch.clamp(patch_conc, max=cfg.num_rings_of_interest - 1)
    cc = conc_clamped.long()
    is_upright = uprightness > cfg.uprightness_thr
    is_not_elevated = near & (elevation
                              < state.elevation_thr[chain_of_patch, cc])
    is_flat = near & (flatness < state.flatness_thr[chain_of_patch, cc])
    is_heading_out = heading < 0.0

    store = enough & is_upright & is_not_elevated & near
    patch_ground = enough & is_upright & (
        ~near | (is_heading_out & (is_not_elevated | is_flat)))
    candidate = (enough & is_upright & near & is_heading_out
                 & ~(is_not_elevated | is_flat))

    # ---- TGR ----
    if cfg.enable_tgr:
        num_r = cfg.num_rings_of_interest
        ring_of = (torch.where(near, patch_conc, num_r)
                   + chain_of_patch * (num_r + 1)).long()

        def ring_sum(v):
            acc = torch.zeros(k * (num_r + 1), dtype=torch.float64,
                              device=dev)
            acc.index_add_(0, ring_of, v.to(torch.float64))
            return acc.reshape(k, num_r + 1)[:, :num_r].to(torch.float32)

        f_sum = ring_sum(torch.where(store, flatness, 0.0))
        f_cnt = ring_sum(store.to(torch.float32))
        f_mean = f_sum / torch.clamp(f_cnt, min=1)
        f_sq = ring_sum(torch.where(store, flatness ** 2, 0.0))
        f_var = (f_sq - f_cnt * f_mean ** 2) / torch.clamp(f_cnt - 1, min=1)
        f_std = torch.sqrt(torch.clamp(f_var, min=0.0))
        # calc_mean_stdev leaves (0, 0) for < 2 samples
        f_mean = torch.where(f_cnt >= 2, f_mean, 0.0)
        f_std = torch.where(f_cnt >= 2, f_std, 0.0)

        mu = (f_mean[chain_of_patch, cc]
              + 1.5 * f_std[chain_of_patch, cc])
        prob_flatness = 1.0 / (1.0 + torch.exp(
            (flatness - mu) / torch.clamp(mu / 10, min=1e-12)))
        prob_flatness = torch.where(mu > 0, prob_flatness, 0.0)
        prob_flatness = torch.where(
            (n_ground > 1500) & (flatness < cfg.th_dist ** 2), 1.0,
            prob_flatness)
        prob_line = torch.where(line_variable > 8.0, 0.0, 1.0)
        revert = candidate & (prob_line * prob_flatness > 0.5)
        patch_ground = patch_ground | revert

    # ---- point-level assembly (sorted domain, one unsort scatter) ----
    gv_flat = (ground_sel & patch_ground[:, None]).reshape(-1)
    pg_sorted = in_table & gv_flat[torch.clamp(flat, max=kp * cap - 1)]
    code = torch.zeros(kn, dtype=torch.int8, device=dev)
    code[(order + pt_off).reshape(-1)] = (in_table.to(torch.int8)
                                          + pg_sorted.to(torch.int8))
    code = code.reshape(k, n)
    point_patch_ground = code == 2
    # points beyond a patch's table capacity classify against its plane
    covered = code >= 1
    overflow = usable & (patch_ids >= 0) & ~covered
    pid_safe = torch.clamp(gpid, min=0).long()
    dist_overflow = _dot3(xyz, normals[pid_safe]) + ds[pid_safe]
    overflow_ground = (overflow & patch_ground[pid_safe]
                       & (dist_overflow < cfg.th_dist))
    ground = point_patch_ground | overflow_ground

    new_state = _update_state(state, store, elevation, flatness,
                              conc_clamped, cfg, consts.mult)
    aux = {"patch_ground": patch_ground, "normals": normals, "means": means,
           "n_ground": n_ground, "noise": noise}
    return ground, new_state, aux


def _stack_states(states) -> GroundState:
    """States with a leading chain axis, one per given state."""
    return GroundState(*(torch.stack(x) for x in zip(*states)))


def _chain_state(state: GroundState, i: int) -> GroundState:
    """Chain ``i``'s state of a stacked one."""
    return GroundState(*(x[i] for x in state))


def segment_ground(points: torch.Tensor, mask: torch.Tensor,
                   state: GroundState, cfg: GroundConfig):
    """Segment one frame. points (N, 4+) = [x, y, z, intensity, ...] in the
    sensor frame, already z-offset corrected by the caller; mask (N,).
    Returns (ground (N,) bool, new_state, aux), on the device of
    ``points``; one step of :func:`segment_sequence`."""
    g, new_state, aux = _segment_presorted(
        points[None], mask[None], _stack_states([state]), cfg,
        *_presort_frames(points[None], mask[None], cfg),
        _step_consts(cfg, points.device, 1))
    return g[0], _chain_state(new_state, 0), {**aux, "noise": aux["noise"][0]}


def _ring_buffer_append(buf, cnt, ptr, values, sel, max_storage):
    """Append each row's ``sel``-ected ``values`` to that row's ring
    buffer: buf (B, S), cnt and ptr (B,), values and sel (B, P)."""
    k = torch.cumsum(sel.to(torch.int32), 1, dtype=torch.int32) - 1
    write_pos = (ptr[:, None] + k) % max_storage
    idx = torch.where(sel, write_pos, max_storage).long()
    buf = torch.cat([buf, torch.zeros((buf.shape[0], 1), dtype=buf.dtype,
                                      device=buf.device)], dim=1)
    buf.scatter_(1, idx, torch.where(sel, values, 0.0))
    n_new = sel.sum(dim=1, dtype=torch.int32)
    return (buf[:, :max_storage], torch.clamp(cnt + n_new, max=max_storage),
            (ptr + n_new) % max_storage)


def _update_state(state: GroundState, store, elevation, flatness, ring,
                  cfg: GroundConfig, mult) -> GroundState:
    """A-GLE update of every chain: append each chain's stored patches to
    its per-ring histories and re-derive its adaptive thresholds and
    sensor height. The patch arrays are (k x patches,), chain-major;
    ``mult`` (R,): each ring's elevation multiplier of the std."""
    num_r, s = cfg.num_rings_of_interest, cfg.max_storage
    k = state.elev_buf.shape[0]
    store, elevation, flatness, ring = (
        x.reshape(k, -1) for x in (store, elevation, flatness, ring))
    rings = torch.arange(num_r, device=ring.device, dtype=ring.dtype)
    sel = (store[:, None, :] & (ring[:, None, :] == rings[None, :, None])
           ).reshape(k * num_r, -1)

    def append(buf, cnt, ptr, values):
        values = values[:, None, :].expand(k, num_r, values.shape[1])
        buf, cnt, ptr = _ring_buffer_append(
            buf.reshape(k * num_r, s), cnt.reshape(-1), ptr.reshape(-1),
            values.reshape(k * num_r, -1), sel, s)
        return (buf.reshape(k, num_r, s), cnt.reshape(k, num_r),
                ptr.reshape(k, num_r))

    elev_buf, elev_cnt, elev_ptr = append(state.elev_buf, state.elev_cnt,
                                          state.elev_ptr, elevation)
    flat_buf, flat_cnt, flat_ptr = append(state.flat_buf, state.flat_cnt,
                                          state.flat_ptr, flatness)

    def stats(buf, cnt):
        m = torch.arange(s, device=buf.device) < cnt[..., None]
        mean = _sum64(torch.where(m, buf, 0.0), -1) / torch.clamp(cnt, min=1)
        var = _sum64(torch.where(m, (buf - mean[..., None]) ** 2, 0.0), -1) \
            / torch.clamp(cnt - 1, min=1)
        return mean, torch.sqrt(torch.clamp(var, min=0.0))

    e_mean, e_std = stats(elev_buf, elev_cnt)
    f_mean, f_std = stats(flat_buf, flat_cnt)

    return GroundState(
        sensor_height=torch.where(elev_cnt[:, 0] >= 2, -e_mean[:, 0],
                                  state.sensor_height),
        elevation_thr=torch.where(elev_cnt >= 2, e_mean + mult * e_std,
                                  state.elevation_thr),
        flatness_thr=torch.where(flat_cnt >= 2, f_mean + f_std,
                                 state.flatness_thr),
        elev_buf=elev_buf, elev_cnt=elev_cnt, elev_ptr=elev_ptr,
        flat_buf=flat_buf, flat_cnt=flat_cnt, flat_ptr=flat_ptr,
    )


def _scan(points: torch.Tensor, mask: torch.Tensor, cfg: GroundConfig,
          z_offset: float, chains: int):
    """The A-GLE/TGR scan of ``chains`` consecutive chunks of the frames
    side by side, every frame presorted first in one batch. Returns
    (ground (F, N), the chains' final states, stacked)."""
    points = points.clone()
    points[..., 2] = points[..., 2] + (-z_offset)
    with trace.span("ground.presort"):
        presorted = _presort_frames(points, mask, cfg)
    return _scan_presorted(points, mask, presorted, cfg, chains)


def _scan_presorted(points, mask, presorted, cfg: GroundConfig, chains: int):
    """The state-threaded part of :func:`_scan` over z-offset frames and
    their presort: step t segments frame t of every chunk as one batch,
    eagerly on the CPU (:func:`_eager_steps`), as replays of the step's
    CUDA graph on a CUDA device (:func:`_graph_steps`)."""
    f, n = mask.shape
    assert f % chains == 0, (f, chains)
    steps = f // chains
    pre = [x.reshape(chains, steps, *x.shape[1:])
           for x in (points, mask, *presorted)]
    ground = torch.empty((chains, steps, n), dtype=torch.bool,
                         device=points.device)
    consts = _step_consts(cfg, points.device, chains)
    run = _graph_steps if points.device.type == "cuda" else _eager_steps
    with trace.span("ground.scan"):
        state = run(pre, ground, cfg, consts)
        trace.count("steps", steps)
    return ground.reshape(f, n), state


def _eager_steps(pre, ground, cfg: GroundConfig, consts: _StepConsts
                 ) -> GroundState:
    """The scan's steps as calls of :func:`_segment_presorted` from the
    initial state: ``pre`` the (chains, steps, ...) frames and presort,
    each step's mask written into ``ground`` (chains, steps, N). Returns
    the chains' final states, stacked."""
    state = _stack_states([init_ground_state(cfg, device=ground.device)]
                          * ground.shape[0])
    for t in range(ground.shape[1]):
        ground[:, t], state, _ = _segment_presorted(
            *(x[:, t] for x in pre[:2]), state, cfg,
            *(x[:, t] for x in pre[2:]), consts)
    return state


class _StepGraph:
    """One scan step, :func:`_segment_presorted` for k chains, captured as a
    CUDA graph over static buffers: ``inputs`` (a frame's points, mask and
    presort, copied in before each replay), ``state`` (the replay writes
    the new state over the state it read) and ``ground`` (the step's (k, N)
    mask, valid until the next replay). The capture runs on a side stream
    after one eager step there (lazy initialisation stays out of the
    graph), in thread-local mode: another thread's work on the card, such
    as the runner's prefetch, neither fails the capture nor enters it."""

    def __init__(self, frame, cfg: GroundConfig, consts: _StepConsts):
        dev = frame[0].device
        self.inputs = [torch.empty(x.shape, dtype=x.dtype, device=dev)
                       for x in frame]
        self.init = _stack_states([init_ground_state(cfg, device=dev)]
                                  * frame[0].shape[0])
        self.state = GroundState(*(x.clone() for x in self.init))
        self.done = torch.cuda.Event()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _segment_presorted(*frame[:2], self.state, cfg, *frame[2:],
                               consts)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            self.ground, new_state, _ = _segment_presorted(
                *self.inputs[:2], self.state, cfg, *self.inputs[2:], consts)
            for dst, src in zip(self.state, new_state):
                dst.copy_(src)

    def scan(self, pre, ground) -> GroundState:
        """:func:`_eager_steps` by replays, on the current stream, from
        the initial state; returns a copy of the final state."""
        torch.cuda.current_stream().wait_event(self.done)
        for dst, src in zip(self.state, self.init):
            dst.copy_(src)
        for t in range(ground.shape[1]):
            for dst, x in zip(self.inputs, pre):
                dst.copy_(x[:, t])
            self.graph.replay()
            ground[:, t] = self.ground
        state = GroundState(*(x.clone() for x in self.state))
        self.done.record()
        return state


_GRAPHS: "OrderedDict[tuple, _StepGraph]" = OrderedDict()
_GRAPHS_KEPT = 4          # the most recently used step graphs kept
_GRAPHS_LOCK = threading.Lock()


def _graph_steps(pre, ground, cfg: GroundConfig, consts: _StepConsts
                 ) -> GroundState:
    """:func:`_eager_steps` on a CUDA device: the step's graph, captured at
    the first scan of its device, chains k, points N and width C and
    config (not the frame count), then replayed once a step. Counts
    ``graph_captures`` and ``graph_replays``. The graphs' buffers are
    shared, so scans run one at a time (a lock, and each scan's stream
    waits for the previous scan's last replay)."""
    points = pre[0]
    key = (ground.device, ground.shape[0], ground.shape[2], points.shape[-1],
           points.dtype, cfg)
    with _GRAPHS_LOCK, torch.cuda.device(ground.device):
        step = _GRAPHS.pop(key, None)
        captured = step is None
        if captured:
            step = _StepGraph([x[:, 0] for x in pre], cfg, consts)
        _GRAPHS[key] = step
        while len(_GRAPHS) > _GRAPHS_KEPT:
            _GRAPHS.popitem(last=False)
        state = step.scan(pre, ground)
    trace.count("graph_captures", int(captured))
    trace.count("graph_replays", ground.shape[1])
    return state


def segment_sequence(points: torch.Tensor, mask: torch.Tensor,
                     cfg: GroundConfig, z_offset: float = 0.0):
    """Ground segmentation over a frame sequence, carrying the A-GLE/TGR
    state from frame to frame. points (F, N, 4+) sensor frame, mask
    (F, N). The z offset mirrors the reference's ground masking call.
    Returns (ground (F, N) bool, final state)."""
    ground, state = _scan(points, mask, cfg, z_offset, 1)
    return ground, _chain_state(state, 0)


def segment_sequence_chained(points: torch.Tensor, mask: torch.Tensor,
                             cfg: GroundConfig, z_offset: float,
                             chains: int) -> torch.Tensor:
    """:func:`segment_sequence` as ``chains`` concurrent scans of
    consecutive frame chunks on one device, each with its own A-GLE/TGR
    state and warm-up; the JAX package's ``segment_sequence_chained``.

    The scan's step is small (the patches' 3x3 PCAs), so batching k
    chunks' frames into one step cuts the sequential steps, and their
    launches, k-fold. Contract: the result equals the per-chunk
    :func:`segment_sequence` scans concatenated; the first frames of each
    chunk see un-adapted thresholds as frame 0 of any scan does, so the
    masks differ from the single scan's at the chunk heads. The stage
    takes it with ``parallel.ground_chains`` (default off). Returns
    ground (F, N) bool; F must be a multiple of ``chains``."""
    return _scan(points, mask, cfg, z_offset, chains)[0]
