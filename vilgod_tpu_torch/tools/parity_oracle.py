"""The transcribed reference decision model (the "oracle") and the composed
ΔAP; the port of the JAX package's ``tools/parity_oracle.py``.

The oracle transcribes the reference's pure-Python decision stages —
tracking (``tracker.py:32-80``, ``dataclass/objects.py:202-334``), box
fitting (``zero_shot_detector.py:422-684``) and label propagation
(``zero_shot_detector.py:686-824``) — into a small numpy object model, with
the same names and decisions as the JAX package's copy. Its numerics are
the port's: the rectangle fit is ``ops/boxes.min_area_rect`` and the Kalman
steps are ``tracking/kalman``'s, so a difference between the oracle and
the port's table stages is a decision, not a kernel's rounding.
``tests/test_torch_reference_parity.py`` pins decision-level equality
between the oracle and the port's stages 5 and 7-9 on a planted scenario,
and each oracle function against the JAX package's.

:func:`measure_delta_ap` composes the oracle with the port's real geometry
stages: ground, entropy, clustering and filter run once; the detections
are snapshotted; the port's table stages and the oracle both decide over
them; both detection sets are scored with the port's Waymo-protocol AP
against the same ground truth; the result is |ΔAP| per class. The bench
(``tools/bench.py``) records it as ``delta_ap_max``.

    python -m vilgod_tpu_torch.tools.parity_oracle              # the card
    python -m vilgod_tpu_torch.tools.parity_oracle --device cpu --scene small

``--scene parity`` (the default) is the bench's 24-frame parity scene at
the bench's full caps; ``--scene small`` the JAX tool's own 16-frame scene
and caps. The rectangle fits of both sides run on the device of the
state; everything else of the oracle is host numpy.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops.boxes import min_area_rect
from ..tracking.kalman import kf_init, kf_predict, kf_update
from ..utils.common import resolve_device

CLS_KEY = "clip"
CLASS_NAMES = ["Vehicle", "Pedestrian", "Cyclist"]


def _bucket(n: int, lo: int = 256) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def rect_fit(points2d: np.ndarray, cap: int = 256, device=None):
    """The shared rectangle fit: the port's ``min_area_rect`` on one
    cluster padded to a power-of-two bucket, on ``device`` (the card unless
    told otherwise). Both sides call it; their decisions are what differ."""
    dev = resolve_device(device)
    cap = _bucket(len(points2d), cap)
    p = np.zeros((1, cap, 2), np.float32)
    m = np.zeros((1, cap), bool)
    p[0, : len(points2d)] = points2d
    m[0, : len(points2d)] = True
    corners, rz, area = min_area_rect(torch.from_numpy(p).to(dev),
                                      torch.from_numpy(m).to(dev),
                                      step_deg=0.5)
    return (corners[0].cpu().numpy(), float(rz[0].cpu()),
            float(area[0].cpu()))


# ---------------------------------------------------------------------------
# reference object model, transcribed decisions
# ---------------------------------------------------------------------------

class ODet:
    """Detection object model (objects.py:37-127)."""

    def __init__(self, pts, static, fnr, col):
        self.cluster_points = pts
        self.valid = True
        self.static = static
        self.static_track = None
        self.track_prediction = False
        self.object_class = {}
        self.object_class_score = {}
        self.bounding_box = None
        self.fnr, self.col = fnr, col  # bookkeeping for table comparison

    @property
    def cluster_mass_center(self):
        # objects.py:121-123 — recomputed on EVERY access; this is what
        # makes the KF write-back at objects.py:308 dead code
        return np.median(self.cluster_points, axis=0)

    @property
    def n_points(self):
        return len(self.cluster_points)


class OTrack:
    """Track object model (objects.py:202-334), KF via the port's
    batched step functions (``tracking/kalman``) on single rows."""

    def __init__(self):
        self.detections = []
        self.frame_indices = []
        self.valid = True
        self.active = True
        self.static = True
        self.miss = 0
        self.kf_x = self.kf_p = self.pred = None

    def init(self, det, fnr):
        x, p = kf_init(det.cluster_mass_center[None, :2])
        self.kf_x, self.kf_p = x[0], p[0]
        self.detections.append(det)
        self.frame_indices.append(fnr)
        self.pred = det.cluster_mass_center.copy()  # objects.py:283-289

    def predict(self):
        x, p = kf_predict(self.kf_x[None], self.kf_p[None])
        self.kf_x, self.kf_p = x[0], p[0]
        self.pred[:2] = self.kf_x[:2]
        self.pred[2] = self.detections[-1].cluster_mass_center[2]

    def update(self, det, fnr):
        if det is not None:  # objects.py:300-308
            self.miss = 0
            x, p = kf_update(self.kf_x[None], self.kf_p[None],
                             det.cluster_mass_center[None, :2])
            self.kf_x, self.kf_p = x[0], p[0]
            # objects.py:308 writes kf.x[:2] into cluster_mass_center —
            # dead: the property recomputes the raw median on next access
        else:  # miss: clone last detection (objects.py:309-317)
            src = self.detections[-1]
            det = ODet(src.cluster_points, src.static, src.fnr, src.col)
            det.object_class = dict(src.object_class)
            det.object_class_score = dict(src.object_class_score)
            det.track_prediction = True
            self.miss += 1
        self.detections.append(det)
        self.frame_indices.append(fnr)

    def finalize(self):
        """Trim trailing prediction steps (objects.py:322-334)."""
        self.active = False
        cnt = 0
        for d in reversed(self.detections):
            if not d.track_prediction:
                break
            cnt += 1
        if cnt:
            self.detections = self.detections[:-cnt]
            self.frame_indices = self.frame_indices[:-cnt]


def oracle_greedy(det_xy, trk_xy, max_distance):
    """assign_detections_greedy (tracking_utils.py:54-95)."""
    if len(det_xy) == 0 or len(trk_xy) == 0:
        return np.empty((0, 2), int), np.array([], bool)
    cost = np.linalg.norm(det_xy[:, None, :2] - trk_xy[None, :, :2], axis=-1)
    d, t = cost.shape
    order = np.argsort(cost.reshape(-1))
    du = [-1] * d
    tu = [-1] * t
    matches = []
    for flat in order:
        di, ti = int(flat // t), int(flat % t)
        if du[di] == -1 and tu[ti] == -1:
            du[di], tu[ti] = ti, di
            matches.append([di, ti])
    matches = np.array(matches).reshape(-1, 2)
    overlap = np.full(d, max_distance + 1.0)
    overlap[matches[:, 0]] = cost[matches[:, 0], matches[:, 1]]
    return matches, overlap < max_distance


def oracle_track(frames, max_distance=1.0, max_missed=3):
    """Tracker.next loop (tracker.py:32-80)."""
    tracks = []
    for fnr, dets in enumerate(frames):
        active = [t for t in tracks if t.active]
        for t in active:
            t.predict()
        trk_xy = np.array([t.pred[:2] for t in active]).reshape(-1, 2)
        det_xy = np.array([d.cluster_mass_center[:2] for d in dets]
                          ).reshape(-1, 2)
        matches_all, mask = oracle_greedy(det_xy, trk_xy, max_distance)
        matches = (matches_all[mask[matches_all[:, 0]]]
                   if len(matches_all) else matches_all)
        for t_idx, t in enumerate(active):
            if len(matches) and t_idx in matches[:, 1]:
                d_idx = int(matches[matches[:, 1] == t_idx, 0][0])
                t.update(dets[d_idx], fnr)
            elif len(matches_all) and t_idx in matches_all[:, 1]:
                # rescue check (tracker.py:55-64)
                d_idx = int(matches_all[matches_all[:, 1] == t_idx, 0][0])
                n1, n2 = dets[d_idx].n_points, t.detections[-1].n_points
                c1 = dets[d_idx].cluster_mass_center
                c2 = t.detections[-1].cluster_mass_center
                if (min(n1, n2) / max(n1, n2) > 0.7
                        and np.linalg.norm(c1 - c2) < 5):
                    t.update(dets[d_idx], fnr)
                else:
                    t.update(None, fnr)
            else:
                if t.miss >= max_missed:
                    t.finalize()
                else:
                    t.update(None, fnr)
        # spawn for dets not in the FILTERED matches (tracker.py:71-76)
        for d_idx, det in enumerate(dets):
            if len(matches) == 0 or d_idx not in matches[:, 0]:
                t = OTrack()
                t.init(det, fnr)
                tracks.append(t)
    for t in tracks:
        if t.active:
            t.finalize()
    return [t for t in tracks if t.valid]


def angle_between_deg(v1, v2):
    """common_utils.angle_between_vectors (common_utils.py:73-76)."""
    with np.errstate(invalid="ignore"):
        cos = v1 @ v2 / (np.linalg.norm(v1) * np.linalg.norm(v2))
    cos = np.clip(cos, -0.9999, 0.9999)
    return np.rad2deg(np.arccos(cos))


def oracle_motion_vectors(cluster_points_list):
    """calc_motion_vectors (zero_shot_detector.py:491-568)."""
    centers_xy, center_indices = [], []
    for p_idx, pts in enumerate(cluster_points_list):
        if pts.shape[0] > 0:
            centers_xy.append(np.median(pts[..., :2], axis=0))
            center_indices.append(p_idx)
    centers_xy = np.array(centers_xy)
    motion_vectors, mv_index = [], []
    vector_far = None
    for c_idx, centers in enumerate(centers_xy):
        c_idx_far = min(c_idx + 10 - 1, len(centers_xy) - 1)
        vector_far_ = centers_xy[c_idx_far] - centers
        if np.linalg.norm(vector_far_) < 0.5 and vector_far is None:
            k = 1
            while (np.linalg.norm(vector_far_) < 0.5
                   and (c_idx_far + k) < len(centers_xy)):
                vector_far_ = centers_xy[c_idx_far + k] - centers
                k += 1
            if np.linalg.norm(vector_far_) >= 0.5:
                vector_far = vector_far_
        elif np.linalg.norm(vector_far_) < 0.5:
            pass  # keep last far vector
        else:
            vector_far = vector_far_
        if vector_far is None:
            return [], []
        vectors, mean_norm = [], 0.0
        for i in range(c_idx + 1, c_idx_far):
            vn = centers_xy[i] - centers
            if angle_between_deg(vector_far, vn) < 60 and np.linalg.norm(vn) > 0.3:
                vectors.append(vn * (0.95 ** (i + 1)))
                mean_norm += 0.9 ** (i + 1)
        if vectors:
            mv = np.mean(vectors, axis=0) / mean_norm
            if motion_vectors:
                mv = mv * 0.5 + motion_vectors[-1] * 0.5
            motion_vectors.append(mv)
        elif motion_vectors:
            motion_vectors.append(motion_vectors[-1])
        else:
            motion_vectors.append(vector_far)
        mv_index.append(center_indices[c_idx])
    return motion_vectors, mv_index


def oracle_simple_fit(pts, cap: int = 256, device=None):
    """Static simple fit (zero_shot_detector.py:450-461)."""
    corners, rz, _ = rect_fit(pts[:, :2], cap, device)
    l = np.linalg.norm(corners[0] - corners[1])
    w = np.linalg.norm(corners[0] - corners[-1])
    c = (corners[0] + corners[2]) / 2
    if w > l:
        l, w = w, l
        rz += np.pi / 2
    h = pts[:, 2].max() - pts[:, 2].min()
    return np.array([c[0], c[1], pts[:, 2].min() + h / 2, l, w, h + 0.3, rz])


def oracle_fit(tracks, transform_to_ego, cap: int = 256, device=None):
    """fit_bounding_boxes_simple, tracked branch (zsd.py:464-684)."""
    for track in tracks:
        possibly_moving = any(not d.static for d in track.detections)
        if not possibly_moving:
            for d in track.detections:
                d.bounding_box = oracle_simple_fit(d.cluster_points, cap,
                                                   device)
            continue
        cluster_points = [d.cluster_points for d in track.detections]
        motion_vectors, _ = oracle_motion_vectors(cluster_points)
        boxes, corner_list = [], []
        for c_idx, direction in enumerate(motion_vectors):
            angle = np.arctan2(direction[1], direction[0])
            c, s = np.cos(angle), np.sin(angle)
            rot_mat = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
            center = np.median(cluster_points[c_idx][..., :3], axis=0)
            proj = np.dot(cluster_points[c_idx][..., :3] - center, rot_mat)
            min_x, max_x = proj[:, 0].min(), proj[:, 0].max()
            min_y, max_y = proj[:, 1].min(), proj[:, 1].max()
            rval = np.array([[max_x, min_y], [min_x, min_y],
                             [min_x, max_y], [max_x, max_y]], np.float32)
            corners = np.dot(rval, rot_mat[:2, :2].T) + center[:2]
            w = np.linalg.norm(corners[0] - corners[1])
            l = np.linalg.norm(corners[0] - corners[-1])
            cc = (corners[0] + corners[2]) / 2
            corner_list.append(corners)
            height = (cluster_points[c_idx][:, 2].max()
                      - cluster_points[c_idx][:, 2].min())
            boxes.append(np.array([cc[0], cc[1],
                                   cluster_points[c_idx][:, 2].min() + height / 2,
                                   w, l, height, angle]))
        if len(boxes) > 0:
            boxes = np.array(boxes)
            k_idx = np.argsort([len(cp) for cp in cluster_points])[-3:]
            heights = np.array([np.max(cp[..., 2]) for cp in cluster_points])
            median_box = np.median(boxes[k_idx], axis=0)
            # closest corner to ego per step (zsd.py:617-621)
            cc_idxs = []
            for c_idx, f_idx in enumerate(track.frame_indices):
                t = transform_to_ego(f_idx)
                ego = corner_list[c_idx] @ t[:3, :3][:2, :2].T + t[:2, 3]
                cc_idxs.append(int(np.argmin(np.linalg.norm(ego, axis=1))))
            for cc_idx, cc in enumerate(cc_idxs):  # zsd.py:627-658
                diff_w = median_box[3] - boxes[cc_idx, 3]
                diff_l = median_box[4] - boxes[cc_idx, 4]
                a = np.arctan2(motion_vectors[cc_idx][1],
                               motion_vectors[cc_idx][0])
                sw = diff_w / 2 * np.cos(a), diff_w / 2 * np.sin(a)
                sl = diff_l / 2 * np.sin(-a), diff_l / 2 * np.cos(-a)
                if cc == 0:
                    boxes[cc_idx, 0] += -sw[0] + sl[0]
                    boxes[cc_idx, 1] += -sw[1] + sl[1]
                elif cc == 1:
                    boxes[cc_idx, 0] += sw[0] + sl[0]
                    boxes[cc_idx, 1] += sw[1] + sl[1]
                elif cc == 2:
                    boxes[cc_idx, 0] += sw[0] - sl[0]
                    boxes[cc_idx, 1] += sw[1] - sl[1]
                else:
                    boxes[cc_idx, 0] += -sw[0] - sl[0]
                    boxes[cc_idx, 1] += -sw[1] - sl[1]
            boxes[:, 3:6] = median_box[3:6]
            boxes[:, 2] = heights - median_box[5] / 2
            for b_idx in range(len(boxes)):
                track.detections[b_idx].bounding_box = boxes[b_idx]
                track.detections[b_idx].static_track = False
            track.static = False
        else:  # no derivable motion (zsd.py:668-682)
            for d in track.detections:
                d.static_track = True
                d.bounding_box = oracle_simple_fit(d.cluster_points, cap,
                                                   device)


def oracle_check_box(box):
    """check_box size prior (zsd.py:691-701)."""
    l, w, h = box[3:6]
    if 0.8 < h <= 2.3 and 0.2 < w <= 1 and 0.2 < l <= 1:
        return "Pedestrian"
    if 1.4 < h <= 2 and 0.5 < w <= 1 and 1 < l <= 2.5:
        return "Cyclist"
    if 0.5 < w <= 3 and 0.5 < l <= 8.0 and 1 < h <= 3:
        return "Vehicle"
    return "Background"


def oracle_bin_angles(angles, n_bins=45):
    """bin_angles (pointcloud_utils.py:525-560), digitize semantics."""
    edges = np.linspace(0, np.pi, n_bins + 1)
    counts = [0] * n_bins
    binned = [[] for _ in range(n_bins)]
    for a in angles:
        na = a % (2 * np.pi)
        if na > np.pi:
            na %= np.pi
        bi = int(np.digitize(na, edges, right=False)) - 1
        if 0 <= bi < n_bins:
            counts[bi] += 1
            binned[bi].append(na)
    return counts, binned[int(np.argmax(counts))]


def _rect_corners(box):
    cx, cy, dx, dy, a = box[0], box[1], box[3], box[4], box[6]
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[c, -s], [s, c]])
    local = np.array([[dx / 2, dy / 2], [dx / 2, -dy / 2],
                      [-dx / 2, -dy / 2], [-dx / 2, dy / 2]])
    return local @ rot.T + np.array([cx, cy])


def rects_overlap(b1, b2):
    """BEV rotated-rectangle overlap via separating axes (stands in for
    iou3d > 0 over z-flattened slabs, zsd.py:727-738)."""
    c1, c2 = _rect_corners(b1), _rect_corners(b2)
    for a in (b1[6], b2[6]):
        for axis in (np.array([np.cos(a), np.sin(a)]),
                     np.array([-np.sin(a), np.cos(a)])):
            p1, p2 = c1 @ axis, c2 @ axis
            if p1.max() <= p2.min() or p2.max() <= p1.min():
                return False
    return True


def oracle_propagate(tracks, min_length=5):
    """propagate_labels (zsd.py:686-824)."""
    for track in tracks:
        if len(track.detections) < min_length:  # zsd.py:704-708
            for d in track.detections:
                d.valid = False
            continue
        max_score, class_name, class_count = 0.0, "Background", {}
        for d in track.detections:  # zsd.py:713-724
            if d.track_prediction:
                continue
            if d.object_class_score[CLS_KEY] > max_score:
                max_score = d.object_class_score[CLS_KEY]
                class_name = d.object_class[CLS_KEY]
            cn = d.object_class[CLS_KEY]
            class_count[cn] = class_count.get(cn, 0) + 1
        if not track.static:  # demotion (zsd.py:727-741)
            boxes = np.array([d.bounding_box for d in track.detections])
            ref = boxes[np.argmax(np.prod(boxes[:, 3:5], axis=1))]
            if all(rects_overlap(ref, b) for b in boxes):
                track.static = True
                for d in track.detections:
                    d.static_track = True
        if track.static:  # static median box + size gate (zsd.py:744-769)
            boxes, n_points = [], []
            for d in track.detections:
                if d.track_prediction:
                    continue
                boxes.append(d.bounding_box)
                n_points.append(len(d.cluster_points))
            if len(boxes) > 0:
                boxes = np.array(boxes)[np.argsort(n_points)[::-1][:10]]
                _, angles = oracle_bin_angles(boxes[:, 6])
                median_box = np.median(boxes, axis=0)
                median_box[6] = np.mean(angles)
                l, w, h = median_box[3:6]
                if l < 0.2 or l > 20 or w < 0.2 or w > 3.5 or h < 0.5 or h > 4:
                    track.valid = False
                    for d in track.detections:
                        d.valid = False
                    continue
                for d in track.detections:
                    d.bounding_box = median_box.copy()
        n_dets = len(track.detections)
        if not track.static:  # zsd.py:771-801
            for d in track.detections:
                if d.track_prediction:
                    continue
                frac = class_count.get(class_name, 0) / n_dets
                if class_name in CLASS_NAMES and (max_score >= 0.5 or frac >= 0.6):
                    d.object_class[CLS_KEY] = class_name
                    d.object_class_score[CLS_KEY] = max_score
                elif (class_name in CLASS_NAMES
                      and class_name in ("Cyclist", "Pedestrian")
                      and (max_score >= 0.35 or frac >= 0.6)):
                    d.object_class[CLS_KEY] = class_name
                    d.object_class_score[CLS_KEY] = 0.7
                elif class_name == "Background" and max_score >= 0.3:
                    d.object_class[CLS_KEY] = class_name
                    d.object_class_score[CLS_KEY] = max_score
                else:
                    d.object_class[CLS_KEY] = oracle_check_box(d.bounding_box)
                    d.object_class_score[CLS_KEY] = 0.5
                d.static_track = False
                box = d.bounding_box.copy()
                box[3:5] += 0.3
                d.bounding_box = box
        else:  # zsd.py:802-822
            for d in track.detections:
                if d.track_prediction:
                    continue
                frac = class_count.get(class_name, 0) / n_dets
                if class_name in CLASS_NAMES and (max_score >= 0.5 or frac >= 0.6):
                    d.object_class[CLS_KEY] = class_name
                    d.object_class_score[CLS_KEY] = max_score
                elif class_name == "Background" and max_score >= 0.3:
                    d.object_class[CLS_KEY] = "Background"
                    d.object_class_score[CLS_KEY] = 1.0
                box = d.bounding_box.copy()
                box[3:5] += 0.3
                d.bounding_box = box


# ---------------------------------------------------------------------------
# composed end-to-end ΔAP: real geometry stages feed BOTH decision models
# ---------------------------------------------------------------------------

def planted_class(fnr: int, col: int, pts: np.ndarray):
    """Deterministic pseudo-CLIP vote, identical on both sides.

    Uses the reference's size prior (check_box) on the cluster's AABB for
    the name — so votes correlate with geometry and the AP is meaningful —
    and a (fnr, col)-hashed score spanning every propagation threshold
    (0.3 / 0.35 / 0.5)."""
    ext = pts.max(0) - pts.min(0)
    name = oracle_check_box(np.array([0, 0, 0, max(ext[0], ext[1]),
                                      min(ext[0], ext[1]), ext[2], 0.0]))
    score = 0.25 + 0.07 * ((fnr * 31 + col * 17) % 10)
    return name, float(score)


def oracle_frame_results(tracks, state, class_names=CLASS_NAMES):
    """Assemble per-frame det dicts from the oracle's objects with the
    same export semantics as the port's ``pipeline/stages_boxes.
    evaluate_sequence``: valid foreground dets, ego frame."""
    per_frame = {f: ([], [], []) for f in range(state.n_frames)}
    for t in tracks:
        for fnr, d in zip(t.frame_indices, t.detections):
            if d.track_prediction or not d.valid or d.bounding_box is None:
                continue
            name = d.object_class.get(CLS_KEY)
            if name not in class_names:
                continue
            tr = state.transform_to_ego(fnr)
            yaw = np.arctan2(tr[1, 0], tr[0, 0])
            b = np.asarray(d.bounding_box, np.float64).copy()
            b[:3] = b[:3] @ tr[:3, :3].T + tr[:3, 3]
            b[6] += yaw
            boxes, names, scores = per_frame[fnr]
            boxes.append(b)
            names.append(name)
            scores.append(float(d.object_class_score[CLS_KEY]))
    out = []
    for f in range(state.n_frames):
        boxes, names, scores = per_frame[f]
        out.append({"boxes_lidar": np.array(boxes).reshape(-1, 7),
                    "name": np.array(names),
                    "score": np.array(scores)})
    return out


def snapshot_detections(state):
    """Every valid detection's cluster points, ``{(frame, cluster):
    (points (n, 3), static)}``, and how many hold more points than
    ``max_cluster_points``. The non-ground cloud, its mask and the labels
    move to the host once (the state's host mirrors), not once per
    detection."""
    ng_mask, labels, ng_xyz = state.ng_mask, state.labels, state.ng_xyz
    cap = int(state.caps.max_cluster_points)
    n_truncated = 0
    snapshot = {}
    for f in range(state.n_frames):
        for c in np.flatnonzero(state.det_valid[f]):
            pts = ng_xyz[f, np.flatnonzero(ng_mask[f] & (labels[f] == c))]
            if len(pts):
                n_truncated += len(pts) > cap
                snapshot[(f, int(c))] = (pts, bool(state.det_static[f, c]))
    return snapshot, n_truncated


def measure_delta_ap(cfg, dataset, seq_name: str,
                     eval_range=(-50.0, -20.0, 50.0, 20.0),
                     return_results: bool = False, device=None) -> dict:
    """Run the port's geometry stages once and the decisions twice (the
    port's tables and the oracle), score both against the ground truth,
    return the per-class AP pairs and |ΔAP|.

    The geometry stages (those of ``cfg["pipeline_active"]`` among the
    first four) run on ``device``, the card unless told otherwise. The
    table side caps each cluster's fit points at ``max_cluster_points``
    (its documented capacity) while centres use all points, and the
    reference has no cap: ``n_truncated`` counts the detections where the
    two could differ, so a nonzero ΔAP with truncation is a capacity
    artefact, not a decision divergence."""
    from ..eval import evaluate_detections
    from ..pipeline.runner import ZeroShotDetector
    from ..pipeline.stages_boxes import (evaluate_sequence,
                                         fit_bounding_boxes_simple,
                                         propagate_labels, track_clusters)
    from ..pipeline.state import MAPPED_CLASSES

    device = resolve_device(device)
    geometry = ["mask_ground_points", "calculate_entropy_scores",
                "spatial_clustering", "filter_detections"]
    cfg = cfg.copy()
    cfg["pipeline_active"] = [s for s in cfg.get(
        "pipeline_active", geometry) if s in geometry] or geometry

    seq = dataset.sequence(seq_name)
    zsd = ZeroShotDetector(seq, seq_name, cfg, device=device)
    zsd.process()
    state = zsd.state
    cap = int(state.caps.max_cluster_points)
    snapshot, n_truncated = snapshot_detections(state)

    # --- table side -------------------------------------------------------
    track_clusters(state, cfg)
    for (f, c), (pts, _static) in snapshot.items():
        name, score = planted_class(f, c, pts)
        state.det_cls[f, c] = MAPPED_CLASSES.index(name)
        state.det_score[f, c] = score
    fit_bounding_boxes_simple(state, cfg)
    propagate_labels(state, cfg)
    table_results = evaluate_sequence(state, cfg)

    # --- oracle side -------------------------------------------------------
    frames = []
    for f in range(state.n_frames):
        dets = []
        for c in sorted(c for (ff, c) in snapshot if ff == f):
            pts, static = snapshot[(f, c)]
            dets.append(ODet(pts, static, f, c))
        frames.append(dets)
    tracks = oracle_track(frames)
    for t in tracks:
        for d in t.detections:
            if not d.track_prediction:
                name, score = planted_class(d.fnr, d.col,
                                            snapshot[(d.fnr, d.col)][0])
                d.object_class[CLS_KEY] = name
                d.object_class_score[CLS_KEY] = score
    oracle_fit(tracks, state.transform_to_ego, cap, device)
    oracle_propagate(tracks)
    oracle_results = oracle_frame_results(tracks, state)

    gt_annos = [seq.get_annos(f) for f in range(state.n_frames)]
    ap_table = evaluate_detections(table_results, gt_annos,
                                   eval_range=eval_range)
    ap_oracle = evaluate_detections(oracle_results, gt_annos,
                                    eval_range=eval_range)
    out = {"per_class": {}, "delta_ap_max": 0.0, "n_truncated": n_truncated,
           "n_dets_table": int(sum(len(r["boxes_lidar"]) for r in table_results)),
           "n_dets_oracle": int(sum(len(r["boxes_lidar"]) for r in oracle_results))}
    for cls in CLASS_NAMES:
        key = f"OBJECT_TYPE_TYPE_{cls.upper()}_LEVEL_2/AP"
        t_ap, o_ap = float(ap_table[key]), float(ap_oracle[key])
        d = abs(t_ap - o_ap)
        out["per_class"][cls] = {"table": round(t_ap, 4),
                                 "oracle": round(o_ap, 4),
                                 "delta": round(d, 4)}
        out["delta_ap_max"] = max(out["delta_ap_max"], round(d, 4))
    if return_results:
        out["_results"] = (table_results, oracle_results, gt_annos)
    return out


# the JAX tool's own scene and caps (tools/parity_oracle.py main)
SMALL_CAPS = {"max_points": 32768, "max_ng_points": 16384, "max_clusters": 64,
              "max_cluster_points": 4096, "max_tracks": 128,
              "max_cluster_input": 16384, "clip_batch": 8}
SMALL_SCENE = dict(n_sequences=1, n_frames=16, seed=12, n_ground=6000,
                   n_vehicles=4, n_pedestrians=2, n_cyclists=1, n_moving=2,
                   area=60.0)


def main(argv=None) -> int:
    from ..config import waymo_config
    from ..data import SyntheticDataset
    from .scenes import CAPS, SCENE

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("parity", "small"), default="parity")
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: cuda)")
    args = ap.parse_args(argv)
    caps, scene = ((CAPS, SCENE) if args.scene == "parity"
                   else (SMALL_CAPS, SMALL_SCENE))
    ds = SyntheticDataset(**scene)
    out = measure_delta_ap(waymo_config(capacity=caps), ds,
                           ds.sequence_names()[0], device=args.device)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
