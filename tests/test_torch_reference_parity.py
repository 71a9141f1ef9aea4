"""Decision-level parity of the port's host decision stages with the
transcribed reference (the port's oracle, vilgod_tpu_torch/tools/
parity_oracle.py), the counterpart of tests/test_reference_parity.py.

The port's track_clusters, fit_bounding_boxes_simple and propagate_labels
(stages 5, 7 and 8) and the port's oracle run over the same planted
scenario (tests/test_reference_parity.py's six tracks, one per decision
branch): same track structure, valid flags, class codes and scores, boxes
and static-track flags. Then each oracle function of the port against the
JAX package's (tools/parity_oracle.py) on the same numpy inputs: decisions
equal, boxes within 1e-4 m (the two sides' rectangle fits are the two
packages' min_area_rect)."""
import numpy as np
import pytest
import torch

import tools.parity_oracle as J
import vilgod_tpu_torch.tools.parity_oracle as T
from test_reference_parity import F, PLANTED_CLASSES, RECT_CAP, scenario
from vilgod_tpu_torch.config import waymo_config
from vilgod_tpu_torch.pipeline.stages_boxes import (fit_bounding_boxes_simple,
                                                    propagate_labels,
                                                    track_clusters)
from vilgod_tpu_torch.pipeline.state import (CLS_NONE, MAPPED_CLASSES,
                                             ST_MOVING, ST_STATIC, ST_UNSET,
                                             Capacity, SequenceState)

CAPS = {"max_points": 1024, "max_ng_points": 2048, "max_clusters": 8,
        "max_cluster_points": RECT_CAP, "max_tracks": 16, "clip_batch": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_state(objs):
    """The planted scenario as a port SequenceState on the CPU (the JAX
    test's build_state)."""
    state = SequenceState.allocate("parity", F, Capacity.from_cfg(
        {"capacity": CAPS}), device="cpu")
    for f in range(F):
        pose = np.eye(4, dtype=np.float64)
        pose[:3, 3] = [0.05 * f, 0.02 * f, 0.0]
        state.poses[f] = pose
        row = 0
        for obj in objs:
            pts = obj.points(f)
            if pts is None:
                continue
            n = len(pts)
            state._h_ng_xyz[f, row:row + n] = pts
            state._h_ng_mask[f, row:row + n] = True
            state._h_labels[f, row:row + n] = obj.col
            state.det_n[f, obj.col] = n
            state.det_center[f, obj.col] = np.median(pts, axis=0)
            state.det_valid[f, obj.col] = True
            state.det_static[f, obj.col] = obj.static
            row += n
        state.points_mask[f, 0] = True
    return state


def oracle_frames(module, objs):
    """Each frame's detections as ``module``'s ODet objects."""
    frames = []
    for f in range(F):
        frames.append([module.ODet(obj.points(f), obj.static, f, obj.col)
                       for obj in objs if obj.points(f) is not None])
    return frames


def plant(tracks, key):
    for t in tracks:
        for d in t.detections:
            if not d.track_prediction:
                name, score = PLANTED_CLASSES[d.col](d.fnr)
                d.object_class[key] = name
                d.object_class_score[key] = score


def run_oracle(module, objs, transform_to_ego, **fit_kw):
    """``module``'s oracle over the scenario: track, plant, fit, propagate."""
    tracks = module.oracle_track(oracle_frames(module, objs))
    plant(tracks, module.CLS_KEY)
    module.oracle_fit(tracks, transform_to_ego, **fit_kw)
    module.oracle_propagate(tracks)
    return tracks


@pytest.fixture(scope="module")
def parity_run():
    objs = scenario()
    cfg = waymo_config(capacity=CAPS)
    state = build_state(objs)
    track_clusters(state, cfg)
    for f in range(F):
        for col in range(6):
            if state.det_n[f, col] > 0:
                name, score = PLANTED_CLASSES[col](f)
                state.det_cls[f, col] = MAPPED_CLASSES.index(name)
                state.det_score[f, col] = score
    fit_bounding_boxes_simple(state, cfg)
    propagate_labels(state, cfg)
    tracks = run_oracle(T, objs, state.transform_to_ego, device="cpu")
    return state, tracks


def _oracle_real_dets(tracks):
    out = {}
    for t in tracks:
        for d in t.detections:
            if not d.track_prediction:
                out[(d.fnr, d.col)] = (d, t)
    return out


def _structure(tracks):
    return {frozenset((int(fnr), int(d.fnr), int(d.col),
                       bool(d.track_prediction))
                      for fnr, d in zip(t.frame_indices, t.detections))
            for t in tracks}


def test_track_structure_matches(parity_run):
    state, tracks = parity_run
    pool = state.tracks
    ours = set()
    for tid in pool.valid_tracks():
        ours.add(frozenset(
            (int(f), int(pool.src_frame[int(tid), f]),
             int(pool.src_cluster[int(tid), f]),
             bool(pool.is_pred[int(tid), f]))
            for f in np.flatnonzero(pool.src_frame[int(tid)] >= 0)))
    assert ours == _structure(tracks)


def test_valid_flags_match(parity_run):
    state, tracks = parity_run
    for (f, c), (d, t) in _oracle_real_dets(tracks).items():
        assert bool(state.det_valid[f, c]) == bool(d.valid), (f, c)


def test_class_codes_and_scores_match(parity_run):
    state, tracks = parity_run
    checked = 0
    for (f, c), (d, t) in _oracle_real_dets(tracks).items():
        code = int(state.det_cls[f, c])
        name = MAPPED_CLASSES[code] if code != CLS_NONE else None
        assert name == d.object_class[T.CLS_KEY], (f, c, name)
        assert float(state.det_score[f, c]) == pytest.approx(
            d.object_class_score[T.CLS_KEY], abs=1e-6), (f, c)
        checked += 1
    assert checked > 50
    final = {(f, c): MAPPED_CLASSES[int(state.det_cls[f, c])]
             for (f, c) in _oracle_real_dets(tracks)}
    assert final[(0, 0)] == "Vehicle"      # static >= 0.5
    assert final[(0, 1)] == "Pedestrian"   # relaxed Ped/Cyc rule
    assert final[(0, 3)] == "Background"   # Background >= 0.3 static
    assert final[(0, 4)] == "Vehicle"      # demoted static, >= 0.5
    assert final[(0, 5)] == "Cyclist"      # frac >= 0.6 static


def test_boxes_match(parity_run):
    state, tracks = parity_run
    for (f, c), (d, t) in _oracle_real_dets(tracks).items():
        ours = state.det_box[f, c]
        ref = d.bounding_box
        assert ref is not None and not np.isnan(ours[0]), (f, c)
        # a rectangle's heading is pi-periodic
        da = (ours[6] - ref[6]) % np.pi
        da = min(da, np.pi - da)
        np.testing.assert_allclose(ours[:6], ref[:6], atol=2e-3,
                                   err_msg=f"det ({f}, {c})")
        assert da < 1e-3 or abs(ours[3] - ours[4]) < 1e-3, (f, c, da)


def test_static_track_flags_match(parity_run):
    state, tracks = parity_run
    to_code = {None: ST_UNSET, False: ST_MOVING, True: ST_STATIC}
    for (f, c), (d, t) in _oracle_real_dets(tracks).items():
        assert int(state.det_static_track[f, c]) == to_code[d.static_track], (f, c)


def test_generate_detections_masking_matches_reference():
    """The port's probability masking and per-cluster static flag (its
    ``segment`` ops and ``compact_labels_any``) against the literal numpy
    transcription of generate_detections (lidar_frame.py:154-248, no-GT
    branch) and filter_by_ephemeral_score (cluster_utils.py:62-64)."""
    from vilgod_tpu_torch.ops import segment as seg_ops
    from vilgod_tpu_torch.ops.cluster import compact_labels_any

    rng = np.random.default_rng(7)
    n, n_clusters = 2048, 9
    labels = rng.integers(-1, n_clusters, n).astype(np.int32)
    raw_map = np.sort(rng.choice(10_000, n_clusters, replace=False))
    raw = np.where(labels >= 0, raw_map[np.maximum(labels, 0)], -1).astype(np.int32)
    probs = rng.uniform(0, 1, n).astype(np.float32)
    entropy = rng.uniform(0, 1, n).astype(np.float32)
    valid = rng.uniform(0, 1, n) < 0.95
    prob_threshold, percentile, min_score = 0.3, 30.0, 0.5

    idx = raw.copy()
    idx[probs < prob_threshold] = -1
    idx[~valid] = -1
    oracle = {}
    for cid in np.unique(idx[idx != -1]):
        sel = idx == cid
        moving = not (np.percentile(entropy[sel], percentile) > min_score)
        oracle[int(cid)] = (int(sel.sum()),
                            tuple(np.round(np.median(
                                np.stack([entropy[sel]] * 3, 1), axis=0), 5)),
                            not moving)

    ent = torch.from_numpy(entropy)
    lab = torch.where(torch.from_numpy(probs) < prob_threshold, -1,
                      torch.from_numpy(raw))
    lab = torch.where(torch.from_numpy(valid), lab, -1)
    lab = compact_labels_any(lab, 16)
    v = torch.from_numpy(valid) & (lab >= 0)
    det_n = seg_ops.seg_count_by_label(lab, v, 16).numpy()
    ephe_p = seg_ops.seg_percentile_by_label(ent, lab, v, 16,
                                             percentile).numpy()
    det_static = ephe_p > min_score
    med = seg_ops.seg_median_by_label(torch.stack([ent] * 3, 1), lab, v,
                                      16).numpy()

    cids = sorted(oracle)
    for rank, cid in enumerate(cids):
        o_n, o_med, o_static = oracle[cid]
        assert det_n[rank] == o_n, (rank, cid)
        np.testing.assert_allclose(med[rank], o_med, atol=1e-5)
        assert bool(det_static[rank]) == o_static, (rank, cid)
    assert det_n[len(cids):].sum() == 0


def test_scenario_branches_were_exercised(parity_run):
    state, tracks = parity_run
    pool = state.tracks
    assert not state.det_valid[3:6, 2].any()          # C: min_length
    tid_d = int(state.det_tid[0, 3])                  # D: misses, trim
    assert pool.is_pred[tid_d, 8:11].all()
    assert pool.src_frame[tid_d, 17:].max() < 0
    tid_b = int(state.det_tid[0, 1])
    tid_e = int(state.det_tid[0, 4])
    assert not pool.static[tid_b]                     # B stays moving
    assert pool.static[tid_e]                         # E demoted
    assert state.det_static_track[0, 4] == ST_STATIC
    assert state.det_static_track[0, 5] == ST_STATIC  # F: static fallback
    assert state.det_static_track[0, 0] == ST_UNSET   # A: never touched


# ---------------------------------------------------------------------------
# each oracle function of the port against the JAX package's
# ---------------------------------------------------------------------------

def _eye(_f):
    return np.eye(4)


def _jumping_frames(module):
    """One cluster that jumps 1.5 m a frame (past the 1 m gate) with a
    slowly shrinking point count: each step takes the tracker's rescue
    (tracker.py:55-64), which the planted scenario never takes."""
    rng = np.random.default_rng(3)
    frames = []
    for f in range(6):
        pts = rng.normal(scale=0.3, size=(100 - 4 * f, 3))
        pts += [1.5 * f, 0.0, 1.0]
        frames.append([module.ODet(pts.astype(np.float32), False, f, 0)])
    return frames


def _check_track():
    objs = scenario()
    for frames_of in (lambda m: oracle_frames(m, objs), _jumping_frames):
        tj = J.oracle_track(frames_of(J))
        tt = T.oracle_track(frames_of(T))
        assert _structure(tj) == _structure(tt)
        for a, b in zip(tj, tt):
            assert (a.miss, a.active, a.static) == (b.miss, b.active,
                                                    b.static)
            np.testing.assert_allclose(a.kf_x, b.kf_x, rtol=1e-12,
                                       atol=1e-12)
            np.testing.assert_allclose(a.pred, b.pred, rtol=1e-12,
                                       atol=1e-12)
    # the first track was rescued at every step (a rescued detection also
    # spawns a track of its own: the spawn reads the gated matches)
    assert tt[0].frame_indices == list(range(6))
    assert not any(d.track_prediction for d in tt[0].detections)


def _check_motion_vectors():
    objs = scenario()
    checked = 0
    for obj in objs:
        pts = [obj.points(f) for f in range(F) if obj.points(f) is not None]
        # a missing step (an empty cluster) is skipped by both
        pts.insert(len(pts) // 2, np.zeros((0, 3), np.float32))
        mj, ij = J.oracle_motion_vectors(pts)
        mt, it = T.oracle_motion_vectors(pts)
        assert ij == it
        np.testing.assert_allclose(np.asarray(mt), np.asarray(mj),
                                   rtol=1e-12, atol=1e-12)
        checked += len(mt)
    assert checked > 0


def _check_bin_angles():
    rng = np.random.default_rng(5)
    for n in (1, 7, 40):
        angles = np.concatenate([rng.uniform(-7, 7, n),
                                 [0.0, np.pi, 2 * np.pi, -np.pi / 2]])
        for n_bins in (45, 8):
            cj, bj = J.oracle_bin_angles(angles, n_bins)
            ct, bt = T.oracle_bin_angles(angles, n_bins)
            assert cj == ct
            np.testing.assert_array_equal(bj, bt)


def _check_rects_overlap():
    rng = np.random.default_rng(9)
    boxes = np.concatenate([rng.uniform(-3, 3, (64, 3)),
                            rng.uniform(0.3, 4, (64, 3)),
                            rng.uniform(-np.pi, np.pi, (64, 1))], axis=1)
    got = [(J.rects_overlap(a, b), T.rects_overlap(a, b))
           for a in boxes[:16] for b in boxes]
    assert all(x == y for x, y in got)
    assert 0 < sum(x for x, _ in got) < len(got)   # both answers occur


def _check_propagate():
    objs = scenario()
    tj = run_oracle(J, objs, _eye)
    tt = run_oracle(T, objs, _eye, device="cpu")
    assert _structure(tj) == _structure(tt)
    dj, dt = _oracle_real_dets(tj), _oracle_real_dets(tt)
    assert set(dj) == set(dt) and len(dt) > 50
    for k in dj:
        a, b = dj[k][0], dt[k][0]
        assert (a.valid, a.static_track) == (b.valid, b.static_track), k
        assert a.object_class == b.object_class, k
        assert a.object_class_score == b.object_class_score, k
        np.testing.assert_allclose(b.bounding_box, a.bounding_box, atol=1e-4,
                                   err_msg=str(k))
    assert [t.static for t in tj] == [t.static for t in tt]
    assert [t.valid for t in tj] == [t.valid for t in tt]


@pytest.mark.parametrize("check", [
    _check_track, _check_motion_vectors, _check_bin_angles,
    _check_rects_overlap, _check_propagate,
], ids=["oracle_track", "oracle_motion_vectors", "oracle_bin_angles",
        "rects_overlap", "oracle_propagate"])
def test_oracle_function_matches_jax(check):
    check()
