"""Track, box-fit, label-propagation and export stages (stages 5, 7-9); the
port of ``vilgod_tpu/pipeline/stages_boxes.py``.

The rectangle fits and the demotion IoU run batched on the state's device
over the shared cluster gather tables (``SequenceState.det_tables``); the
per-track sequential logic (association, motion vectors, label rules) is
host-side numpy over the track pool, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.boxes import (_cos_sin, closeness_rect, iou3d_pairs,
                         min_area_rect, pca_rect, variance_rect)
from ..ops.segment import seg_median
from ..tracking.tracker import Tracker
from .stages_geometry import frame_bucket
from .state import CLS_NONE, MAPPED_CLASSES, ST_MOVING, ST_STATIC, SequenceState

BACKGROUND = MAPPED_CLASSES.index("Background")


# ---------------------------------------------------------------------------
# Stage 5: track_clusters
# ---------------------------------------------------------------------------

def track_clusters(state: SequenceState, cfg, valid_only: bool = True,
                   force: bool = True, **_):
    """Associate each frame's (valid) detections with the track pool."""
    if state.done.get("track_clusters") and not force:
        return
    state.det_tid[...] = -1
    track_cfg = cfg.get("preprocessor", {}).get("tracking", {}).get(
        "cluster", {})
    tracker = Tracker(state.n_frames, track_cfg, cap=state.caps.max_tracks)
    for fnr in range(state.n_frames):
        sel = state.det_valid[fnr] if valid_only else (state.det_n[fnr] > 0)
        clusters = np.flatnonzero(sel)
        tids = tracker.next(fnr, clusters, state.det_center[fnr, clusters],
                            state.det_n[fnr, clusters])
        state.det_tid[fnr, clusters] = tids
    state.tracks = tracker.finish()
    state.done["track_clusters"] = True


# ---------------------------------------------------------------------------
# Stage 7: fit_bounding_boxes_simple
# ---------------------------------------------------------------------------

# the configured rectangle fit by its reference name, and the renames of
# its arguments
_RECT_FITS = {
    "minimum_bounding_rectangle": (min_area_rect, {}),
    "closeness_rectangle": (closeness_rect, {"delta": "delta_deg",
                                             "delta_zero": "delta_zero"}),
    "variance_rectangle": (variance_rect, {"delta": "delta_deg"}),
    "PCA_rectangle": (pca_rect, {}),
}


def _parse_method(method) -> tuple[str, dict]:
    """A pipeline ``method`` entry ({name, args}) -> (name, fit kwargs)."""
    if not method:
        return "minimum_bounding_rectangle", {}
    name = method.get("name", "minimum_bounding_rectangle")
    if name not in _RECT_FITS:
        raise ValueError(f"unknown rectangle fit method {name!r}; "
                         f"known: {sorted(_RECT_FITS)}")
    rename = _RECT_FITS[name][1]
    return name, {rename.get(k, k): float(v)
                  for k, v in (method.get("args") or {}).items()}


def _norm(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _z_extent(pts, mask):
    zmin = torch.where(mask, pts[..., 2], 1e9).amin(dim=1)
    zmax = torch.where(mask, pts[..., 2], -1e9).amax(dim=1)
    return zmin, zmax


def _fit_static_boxes(pts, mask, method="minimum_bounding_rectangle",
                      margs=None):
    """The configured rectangle fit, the z extent and a 0.3 m height pad,
    long side first. pts (B, P, 3), mask (B, P) -> (B, 7)."""
    fit_fn, _ = _RECT_FITS[method]
    kw = dict(margs or {})
    if method == "minimum_bounding_rectangle":
        kw.setdefault("step_deg", 0.5)
    corners, rz, _ = fit_fn(pts[..., :2], mask, **kw)
    l = _norm(corners[:, 0] - corners[:, 1])
    w = _norm(corners[:, 0] - corners[:, 3])
    c = (corners[:, 0] + corners[:, 2]) / 2
    swap = w > l
    l, w = torch.where(swap, w, l), torch.where(swap, l, w)
    rz = torch.where(swap, rz + np.float32(np.pi / 2), rz)
    zmin, zmax = _z_extent(pts, mask)
    h = zmax - zmin
    return torch.stack([c[:, 0], c[:, 1], zmin + h / 2, l, w, h + 0.3, rz],
                       dim=1)


def _fit_heading_boxes(pts, mask, angles):
    """Motion-aligned fits: median centre, points rotated by the heading,
    axis-aligned spans. Returns (boxes (B, 7) [cx, cy, zmin + h/2, w, l,
    h, angle] -- the reference's w-before-l order in this branch --,
    corners (B, 4, 2), zmax (B,))."""
    center = torch.stack([seg_median(pts[..., k], mask) for k in range(3)],
                         dim=1)
    c, s = (v[:, None] for v in _cos_sin(angles))
    x = pts[..., 0] - center[:, None, 0]
    y = pts[..., 1] - center[:, None, 1]
    # (p - center) @ [[c, -s], [s, c]]
    px, py = x * c + y * s, -x * s + y * c
    min_x = torch.where(mask, px, 1e9).amin(dim=1)
    max_x = torch.where(mask, px, -1e9).amax(dim=1)
    min_y = torch.where(mask, py, 1e9).amin(dim=1)
    max_y = torch.where(mask, py, -1e9).amax(dim=1)
    rx = torch.stack([max_x, min_x, min_x, max_x], dim=1)
    ry = torch.stack([min_y, min_y, max_y, max_y], dim=1)
    # rect @ rot.T + center
    corners = torch.stack([rx * c - ry * s + center[:, None, 0],
                           rx * s + ry * c + center[:, None, 1]], dim=2)
    w = _norm(corners[:, 0] - corners[:, 1])
    l = _norm(corners[:, 0] - corners[:, 3])
    cc = (corners[:, 0] + corners[:, 2]) / 2
    zmin, zmax = _z_extent(pts, mask)
    h = zmax - zmin
    boxes = torch.stack([cc[:, 0], cc[:, 1], zmin + h / 2, w, l, h,
                         angles], dim=1)
    return boxes, corners, zmax


def _gather_tables(state: SequenceState, frame_ids, cluster_ids):
    """(frame, cluster) detections gathered from the shared device tables
    -> (pts (B, P, 3), mask (B, P)); padded rows (cluster -1) keep one
    point so their reductions stay finite."""
    f_pad = frame_bucket(state.n_frames)
    n_ng = state.ng_bucket()
    ng_xyz = state.device("ng_xyz", f_pad, n_ng)
    tables, table_masks = state.det_tables(f_pad, n_ng)
    dev = ng_xyz.device
    fids = torch.as_tensor(frame_ids, dtype=torch.int64, device=dev)
    cids = torch.as_tensor(cluster_ids, dtype=torch.int64, device=dev)
    rows = torch.clamp(tables[fids, torch.clamp(cids, min=0)], min=0).long()
    rmask = table_masks[fids, torch.clamp(cids, min=0)] & (cids >= 0)[:, None]
    pts = ng_xyz[fids[:, None], rows]
    pts = torch.where(rmask[..., None], pts, 0.0)
    rmask[:, 0] = True
    return pts, rmask


def _pad_pow2(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _fit_static_chunked(state: SequenceState, dets: list[tuple[int, int]],
                        method=None):
    """Simple-fit a detection list in one batch over the shared gather
    tables; one download."""
    if not dets:
        return
    mname, margs = _parse_method(method)
    b = _pad_pow2(len(dets), lo=64)
    fids = np.zeros(b, np.int64)
    cids = np.full(b, -1, np.int64)
    fids[: len(dets)] = [f for f, _ in dets]
    cids[: len(dets)] = [c for _, c in dets]
    pts, mask = _gather_tables(state, fids, cids)
    boxes = _fit_static_boxes(pts, mask, method=mname, margs=margs).cpu().numpy()
    for i, (f, c) in enumerate(dets):
        state.det_box[f, c] = boxes[i]


def _angle_between_deg(v1, v2):
    """Angle between two vectors in degrees (180 for a zero vector)."""
    n1, n2 = np.linalg.norm(v1), np.linalg.norm(v2)
    if n1 == 0 or n2 == 0:
        return 180.0
    cosang = np.clip(np.dot(v1, v2) / (n1 * n2), -1.0, 1.0)
    return np.degrees(np.arccos(cosang))


def _calc_motion_vectors(centers_xy: np.ndarray):
    """Decayed-mean motion direction per track step.

    centers_xy (S, 2): per-step cluster medians (prediction steps carry
    their source detection's). Returns a list of (2,) vectors, or [] when
    no direction can be derived."""
    s = len(centers_xy)
    motion_vectors = []
    vector_far = None
    for c_idx in range(s):
        c_idx_far = min(c_idx + 9, s - 1)
        vector_far_ = centers_xy[c_idx_far] - centers_xy[c_idx]
        if np.linalg.norm(vector_far_) < 0.5 and vector_far is None:
            idx_counter = 1
            while (np.linalg.norm(vector_far_) < 0.5
                   and (c_idx_far + idx_counter) < s):
                vector_far_ = (centers_xy[c_idx_far + idx_counter]
                               - centers_xy[c_idx])
                idx_counter += 1
            if np.linalg.norm(vector_far_) >= 0.5:
                vector_far = vector_far_
        elif np.linalg.norm(vector_far_) < 0.5:
            pass  # keep the last far vector
        else:
            vector_far = vector_far_

        if vector_far is None:
            return []
        vectors = []
        mean_vector_norm = 0.0
        for i in range(c_idx + 1, c_idx_far):
            vector_next = centers_xy[i] - centers_xy[c_idx]
            if (_angle_between_deg(vector_far, vector_next) < 60
                    and np.linalg.norm(vector_next) > 0.3):
                vectors.append(vector_next * (0.95 ** (i + 1)))
                mean_vector_norm += 0.9 ** (i + 1)
        if vectors:
            mean_vector = np.mean(vectors, axis=0) / mean_vector_norm
            if motion_vectors:
                mean_vector = mean_vector * 0.5 + motion_vectors[-1] * 0.5
            motion_vectors.append(mean_vector)
        elif motion_vectors:
            motion_vectors.append(motion_vectors[-1])
        else:
            motion_vectors.append(vector_far)
    return motion_vectors


def _anchor_to_closest_corner(boxes, median_box, cc_idxs, angles):
    """Move each step's box so its corner closest to the ego stays put when
    the box takes the track's median size."""
    for s_idx, cc in enumerate(cc_idxs):
        diff_w = median_box[3] - boxes[s_idx, 3]
        diff_l = median_box[4] - boxes[s_idx, 4]
        a = angles[s_idx]
        # the reference's four corner cases, term for term
        if cc == 0:
            boxes[s_idx, 0] += -(diff_w / 2) * np.cos(a) + (diff_l / 2) * np.sin(-a)
            boxes[s_idx, 1] += -(diff_w / 2) * np.sin(a) + (diff_l / 2) * np.cos(-a)
        elif cc == 1:
            boxes[s_idx, 0] += (diff_w / 2) * np.cos(a) + (diff_l / 2) * np.sin(-a)
            boxes[s_idx, 1] += (diff_w / 2) * np.sin(a) + (diff_l / 2) * np.cos(-a)
        elif cc == 2:
            boxes[s_idx, 0] += (diff_w / 2) * np.cos(a) - (diff_l / 2) * np.sin(-a)
            boxes[s_idx, 1] += (diff_w / 2) * np.sin(a) - (diff_l / 2) * np.cos(-a)
        else:
            boxes[s_idx, 0] += -(diff_w / 2) * np.cos(a) - (diff_l / 2) * np.sin(-a)
            boxes[s_idx, 1] += -(diff_w / 2) * np.sin(a) - (diff_l / 2) * np.cos(-a)


def fit_bounding_boxes_simple(state: SequenceState, cfg, method=None,
                              valid_only: bool = True, force: bool = True,
                              **_):
    """Static tracks (and untracked runs) get the configured rectangle fit;
    moving tracks get motion-aligned boxes of the track's median size,
    re-anchored at the corner closest to the ego."""
    if state.done.get("fit_bounding_boxes_simple") and not force:
        return
    state.det_box[...] = np.nan
    pool = state.tracks

    if pool is None or len(pool.valid_tracks()) == 0:
        # no tracking: every detection gets the simple fit
        dets = [(f, c) for f in range(state.n_frames)
                for c in np.flatnonzero(state.det_valid[f] if valid_only
                                        else state.det_n[f] > 0)]
        _fit_static_chunked(state, dets, method=method)
        state.done["fit_bounding_boxes_simple"] = True
        return

    static_dets: list[tuple[int, int]] = []
    moving_jobs = []  # (tid, steps)
    for tid in pool.valid_tracks():
        steps = list(pool.steps(int(tid)))
        # possibly moving if any step's source detection is non-static
        if any(not state.det_static[sf, sc] for _, sf, sc, _ in steps):
            moving_jobs.append((int(tid), steps))
        else:
            static_dets.extend({(sf, sc) for _, sf, sc, _ in steps})
    _fit_static_chunked(state, sorted(set(static_dets)), method=method)

    # moving tracks: all heading fits in one batch; the per-track anchoring
    # arithmetic stays on the host
    jobs = []       # (tid, steps, sfs, scs, angles, offset)
    fallback_static: list[tuple[int, list]] = []
    total = 0
    for tid, steps in moving_jobs:
        sfs = np.array([sf for _, sf, sc, _ in steps], np.int32)
        scs = np.array([sc for _, sf, sc, _ in steps], np.int32)
        # per-step mass centres are the raw per-detection medians (the
        # reference recomputes them on every access)
        motion_vectors = _calc_motion_vectors(state.det_center[sfs, scs][:, :2])
        if len(motion_vectors) > 0:
            angles = np.arctan2([v[1] for v in motion_vectors],
                                [v[0] for v in motion_vectors])
            jobs.append((tid, steps, sfs, scs, angles, total))
            total += len(steps)
        else:
            fallback_static.append((tid, steps))

    if jobs:
        pad_s = _pad_pow2(total)
        fids = np.zeros(pad_s, np.int64)
        cids = np.full(pad_s, -1, np.int64)
        angles_p = np.zeros(pad_s, np.float32)
        for _, steps, sfs, scs, angles, off in jobs:
            s = len(steps)
            fids[off:off + s], cids[off:off + s] = sfs, scs
            angles_p[off:off + s] = angles
        pts, mask = _gather_tables(state, fids, cids)
        boxes_d, corners_d, zmax_d = _fit_heading_boxes(
            pts, mask, torch.from_numpy(angles_p).to(pts.device))
        # one download for boxes, corners and zmax
        packed = torch.cat([boxes_d, corners_d.reshape(-1, 8), zmax_d[:, None]],
                           dim=1).cpu().numpy()
        all_boxes = packed[:, :7].copy()
        all_corners = packed[:, 7:15].reshape(-1, 4, 2)
        all_zmaxs = packed[:, 15]

    for tid, steps, sfs, scs, angles, off in jobs:
        s = len(steps)
        boxes = all_boxes[off:off + s].copy()
        corners = all_corners[off:off + s]
        n_points = state.det_n[sfs, scs]
        heights = all_zmaxs[off:off + s]
        k_idx = np.argsort(n_points, kind="stable")[-3:]
        median_box = np.median(boxes[k_idx], axis=0)
        # the corner closest to the ego of each step (world corners taken
        # to that step's ego frame)
        cc_idxs = []
        for s_idx, (f, _, _, _) in enumerate(steps):
            t = state.transform_to_ego(f)
            ego = corners[s_idx] @ t[:3, :3][:2, :2].T + t[:2, 3]
            cc_idxs.append(int(np.argmin(np.linalg.norm(ego, axis=1))))
        _anchor_to_closest_corner(boxes, median_box, cc_idxs, angles)
        boxes[:, 3:6] = median_box[3:6]
        boxes[:, 2] = heights - median_box[5] / 2
        for s_idx, (f, sf, sc, is_pred) in enumerate(steps):
            if not is_pred:
                state.det_box[sf, sc] = boxes[s_idx]
            state.det_static_track[sf, sc] = ST_MOVING
        pool.static[tid] = False

    # no derivable motion direction: static fit and the static_track flag
    fb_dets = sorted({(sf, sc) for _, steps in fallback_static
                      for _, sf, sc, _ in steps})
    _fit_static_chunked(state, fb_dets, method=method)
    for _, steps in fallback_static:
        for _, sf, sc, _ in steps:
            state.det_static_track[sf, sc] = ST_STATIC
    state.done["fit_bounding_boxes_simple"] = True


# ---------------------------------------------------------------------------
# Stage 8: propagate_labels
# ---------------------------------------------------------------------------

def _check_box(box) -> int:
    """Size-prior class fallback."""
    l, w, h = box[3:6]
    if 0.8 < h <= 2.3 and 0.2 < w <= 1 and 0.2 < l <= 1:
        return MAPPED_CLASSES.index("Pedestrian")
    if 1.4 < h <= 2 and 0.5 < w <= 1 and 1 < l <= 2.5:
        return MAPPED_CLASSES.index("Cyclist")
    if 0.5 < w <= 3 and 0.5 < l <= 8.0 and 1 < h <= 3:
        return MAPPED_CLASSES.index("Vehicle")
    return BACKGROUND


def _check_box_geometry(box) -> int:
    """The size prior of the geometry-only runs (no classification stage):
    the static fit's +0.3 m height pad is undone first, or a cyclist's
    ~1.8 m extent lands in the Vehicle bucket."""
    unpadded = np.asarray(box, np.float64).copy()
    unpadded[5] -= 0.3
    return _check_box(unpadded)


def _bin_angles(angles: np.ndarray, n_bins: int = 45):
    """Orientation histogram over [0, pi): (counts, the angles of the
    fullest bin)."""
    edges = np.linspace(0, np.pi, n_bins + 1)
    norm = np.mod(angles, 2 * np.pi)
    norm = np.where(norm > np.pi, np.mod(norm, np.pi), norm)
    bins = np.clip(np.digitize(norm, edges, right=False) - 1, 0, n_bins - 1)
    counts = np.bincount(bins, minlength=n_bins)
    best = int(np.argmax(counts))
    return counts, norm[bins == best]


def _batch_demotion_checks(state: SequenceState, candidates):
    """Moving -> static demotion test of every candidate track in one
    batched IoU on the device: each track's boxes flattened to BEV slabs,
    and the track demotes when ALL of them overlap its largest-footprint
    box. candidates: {tid: steps} -> {tid: bool}."""
    if not candidates:
        return {}
    max_s = _pad_pow2(max(len(s) for s in candidates.values()), lo=8)
    tids = sorted(candidates)
    n_pad = _pad_pow2(len(tids), lo=8)
    refs = np.zeros((n_pad, 7), np.float32)
    flats = np.zeros((n_pad, max_s, 7), np.float32)
    counts = np.zeros(n_pad, np.int64)
    for i, tid in enumerate(tids):
        boxes = np.array([state.det_box[sf, sc]
                          for _, sf, sc, _ in candidates[tid]])
        boxes = boxes[~np.isnan(boxes[:, 0])]
        if not len(boxes):
            continue
        ref = boxes[int(np.argmax(np.prod(boxes[:, 3:5], axis=1)))].copy()
        flat = boxes[:, :7].copy()
        ref[2], ref[5] = 0.0, 1.0
        flat[:, 2], flat[:, 5] = 0.0, 1.0
        refs[i] = ref[:7]
        flats[i, : len(flat)] = flat
        counts[i] = len(flat)
    dev = state.torch_device
    # each track's reference box against its own slabs -> (T, S)
    iou = iou3d_pairs(torch.from_numpy(refs).to(dev)[:, None],
                      torch.from_numpy(flats).to(dev)).cpu().numpy()
    return {tid: counts[i] > 0 and np.count_nonzero(iou[i][:counts[i]])
            == counts[i] for i, tid in enumerate(tids)}


def propagate_labels(state: SequenceState, cfg, min_length: int = 5,
                     classification_key: str = "clip", **_):
    """Per track: drop short tracks, demote overlapping moving tracks to
    static, give static tracks their median box (size-gated), and spread
    the track's class over its steps."""
    pool = state.tracks
    if pool is None:
        return
    class_names = cfg.get("preprocessor", {}).get(
        "class_names", ["Vehicle", "Pedestrian", "Cyclist"])
    fg_codes = {MAPPED_CLASSES.index(c) for c in class_names}

    demote = _batch_demotion_checks(state, {
        int(tid): list(pool.steps(int(tid))) for tid in pool.valid_tracks()
        if not pool.static[int(tid)]
        and len(list(pool.steps(int(tid)))) >= min_length})

    for tid in pool.valid_tracks():
        tid = int(tid)
        steps = list(pool.steps(tid))
        if len(steps) < min_length:
            for _, sf, sc, _ in steps:
                state.det_valid[sf, sc] = False
            continue

        real = [(sf, sc) for _, sf, sc, is_pred in steps if not is_pred]
        # class statistics over the real steps
        max_score, class_code = 0.0, BACKGROUND
        class_count: dict[int, int] = {}
        unclassified = all(state.det_cls[sf, sc] == CLS_NONE for sf, sc in real)
        for sf, sc in real:
            code = int(state.det_cls[sf, sc])
            score = float(state.det_score[sf, sc])
            if code == CLS_NONE:
                code, score = BACKGROUND, 0.0  # geometry-only runs
            if score > max_score:
                max_score, class_code = score, code
            class_count[code] = class_count.get(code, 0) + 1

        # moving -> static when all boxes overlap the largest one
        if not pool.static[tid] and demote.get(tid, False):
            pool.static[tid] = True
            for _, sf, sc, _ in steps:
                state.det_static_track[sf, sc] = ST_STATIC

        # static track: the median box of its 10 fullest steps, size-gated
        if pool.static[tid]:
            boxes, n_points = [], []
            for sf, sc in real:
                if not np.isnan(state.det_box[sf, sc, 0]):
                    boxes.append(state.det_box[sf, sc])
                    n_points.append(state.det_n[sf, sc])
            if boxes:
                boxes = np.array(boxes)[np.argsort(n_points,
                                                   kind="stable")[::-1][:10]]
                _, bin_angle_vals = _bin_angles(boxes[:, 6])
                median_box = np.median(boxes, axis=0)
                median_box[6] = np.mean(bin_angle_vals)
                l, w, h = median_box[3:6]
                if l < 0.2 or l > 20 or w < 0.2 or w > 3.5 or h < 0.5 or h > 4:
                    pool.valid[tid] = False
                    for _, sf, sc, _ in steps:
                        state.det_valid[sf, sc] = False
                    continue
                for _, sf, sc, _ in steps:
                    state.det_box[sf, sc] = median_box

        # label rules
        n_steps = len(steps)
        frac = class_count.get(class_code, 0) / n_steps
        for sf, sc in real:
            if not pool.static[tid]:
                if class_code in fg_codes and (max_score >= 0.5 or frac >= 0.6):
                    state.det_cls[sf, sc] = class_code
                    state.det_score[sf, sc] = max_score
                elif (class_code in fg_codes
                      and MAPPED_CLASSES[class_code] in ("Cyclist", "Pedestrian")
                      and (max_score >= 0.35 or frac >= 0.6)):
                    state.det_cls[sf, sc] = class_code
                    state.det_score[sf, sc] = 0.7
                elif class_code == BACKGROUND and max_score >= 0.3:
                    state.det_cls[sf, sc] = class_code
                    state.det_score[sf, sc] = max_score
                else:
                    state.det_cls[sf, sc] = _check_box(state.det_box[sf, sc])
                    state.det_score[sf, sc] = 0.5
                state.det_static_track[sf, sc] = ST_MOVING
            else:
                if unclassified and not np.isnan(state.det_box[sf, sc, 0]):
                    # geometry-only runs: the size prior, scored by the
                    # cluster's support
                    state.det_cls[sf, sc] = _check_box_geometry(
                        state.det_box[sf, sc])
                    n = float(state.det_n[sf, sc])
                    state.det_score[sf, sc] = n / (n + 200.0)
                elif class_code in fg_codes and (max_score >= 0.5 or frac >= 0.6):
                    state.det_cls[sf, sc] = class_code
                    state.det_score[sf, sc] = max_score
                elif class_code == BACKGROUND and max_score >= 0.3:
                    state.det_cls[sf, sc] = BACKGROUND
                    state.det_score[sf, sc] = 1.0
            # enlarge the box by a small margin
            if not np.isnan(state.det_box[sf, sc, 0]):
                state.det_box[sf, sc, 3:5] += 0.3
    state.done["propagate_labels"] = True


# ---------------------------------------------------------------------------
# Stage 9: evaluate_sequence
# ---------------------------------------------------------------------------

def evaluate_sequence(state: SequenceState, cfg, modes=("detection_3d",),
                      classification_key: str = "clip", **_) -> list[dict]:
    """Per-frame detection dicts in the ego frame: ``boxes_lidar`` (N, 7),
    ``name``, ``score``, ``moving``."""
    class_names = cfg.get("preprocessor", {}).get(
        "class_names", ["Vehicle", "Pedestrian", "Cyclist"])
    fg_codes = {MAPPED_CLASSES.index(c): c for c in class_names}
    results = []
    for fnr in range(state.n_frames):
        t = state.transform_to_ego(fnr)
        yaw = np.arctan2(t[1, 0], t[0, 0])
        boxes, names, scores, moving = [], [], [], []
        for c in np.flatnonzero(state.det_valid[fnr]):
            code = int(state.det_cls[fnr, c])
            if code in fg_codes and not np.isnan(state.det_box[fnr, c, 0]):
                b = state.det_box[fnr, c].copy()
                b[:3] = b[:3] @ t[:3, :3].T + t[:3, 3]
                b[6] += yaw
                boxes.append(b)
                names.append(fg_codes[code])
                scores.append(float(state.det_score[fnr, c]))
                moving.append(state.det_static_track[fnr, c] == ST_MOVING)
        results.append({
            "boxes_lidar": np.array(boxes).reshape(-1, 7),
            "name": np.array(names),
            "score": np.array(scores),
            "moving": np.array(moving, bool),
        })
    state.detection_3d_result_list = results
    return results
