"""The port's tracking copies (vilgod_tpu_torch/tracking/) against
vilgod_tpu/tracking/ on the same numpy inputs, mirroring
tests/test_tracking.py: Kalman states, assignments, track ids and the
serialized track pool must be equal (both are the same host-side numpy;
the Hungarian IoU cost comes from each package's own iou3d_matrix)."""
import numpy as np
import pytest

from vilgod_tpu import tracking as JT
from vilgod_tpu.tracking.tracker import Tracker as JaxTracker
from vilgod_tpu.tracking.tracker import TrackPool as JaxTrackPool
from vilgod_tpu_torch import tracking as TT
from vilgod_tpu_torch.tracking.tracker import Tracker, TrackPool


def test_kalman_matches_jax_package():
    rng = np.random.default_rng(51)
    z0 = rng.uniform(-10, 10, (6, 2))
    xj, pj = JT.kf_init(z0)
    xt, pt = TT.kf_init(z0)
    for step in range(5):
        z = z0 + 0.3 * (step + 1) * np.array([1.0, -0.5])
        xj, pj = JT.kf_update(*JT.kf_predict(xj, pj), z)
        xt, pt = TT.kf_update(*TT.kf_predict(xt, pt), z)
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(pt, pj)


def test_greedy_assignment_matches_jax_package():
    rng = np.random.default_rng(52)
    for _ in range(5):
        dets = rng.uniform(-5, 5, (9, 3))
        trks = dets[rng.permutation(9)[:6]] + rng.normal(0, 0.4, (6, 3))
        for got, want in zip(TT.assign_greedy(dets, trks, max_distance=1.0),
                             JT.assign_greedy(dets, trks, max_distance=1.0)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{"max_distance": 1.0},
                                {"det_overlap_threshold": 0.1}],
                         ids=["distance", "iou"])
def test_hungarian_assignment_matches_jax_package(kw):
    rng = np.random.default_rng(53)
    dets = np.zeros((8, 7))
    dets[:, :2] = rng.uniform(-6, 6, (8, 2))
    dets[:, 3:6] = rng.uniform(1.0, 3.0, (8, 3))
    dets[:, 6] = rng.uniform(-np.pi, np.pi, 8)
    trks = dets[rng.permutation(8)[:5]].copy()
    trks[:, :2] += rng.normal(0, 0.4, (5, 2))
    mt, kt, ot = TT.assign_hungarian(dets, trks, **kw)
    mj, kj, oj = JT.assign_hungarian(dets, trks, **kw)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_allclose(ot, oj, atol=1e-5, rtol=0)
    assert kj.sum() >= 3


def _scene(rng, n_frames=20, n_obj=7):
    """Per frame: (clusters, centres (D, 3), point counts) of objects that
    move, vanish for a few frames, appear late or crowd each other."""
    start = rng.uniform(-20, 20, (n_obj, 3))
    vel = rng.normal(0, 0.25, (n_obj, 3)) * [1, 1, 0]
    vel[0] = [1.5, 0, 0]                     # too fast for the gate
    frames = []
    for f in range(n_frames):
        seen = [o for o in range(n_obj)
                if not (o == 1 and 6 <= f < 8) and not (o == 2 and f >= 12)
                and not (o == 3 and f < 5) and rng.uniform() > 0.05]
        centres = np.array([start[o] + vel[o] * f for o in seen]).reshape(-1, 3)
        centres += rng.normal(0, 0.05, centres.shape)
        clusters = np.array(sorted(rng.choice(40, len(seen), replace=False)),
                            np.int64)
        npts = rng.integers(20, 400, len(seen))
        frames.append((clusters, centres, npts))
    return frames


@pytest.mark.parametrize("method", ["assign_detections_greedy",
                                    "assign_detections_hungarian"])
def test_tracker_matches_jax_package(method):
    """Track ids per frame and the whole serialized pool are equal."""
    cfg = {"assignment": {"method": method, "max_distance": 1.0},
           "max_missed": 3}
    frames = _scene(np.random.default_rng(54))
    tj, tt = JaxTracker(len(frames), cfg, cap=32), Tracker(len(frames), cfg,
                                                          cap=32)
    for fnr, (clusters, centres, npts) in enumerate(frames):
        np.testing.assert_array_equal(tt.next(fnr, clusters, centres, npts),
                                      tj.next(fnr, clusters, centres, npts))
    pj, pt = tj.finish().serialize(), tt.finish().serialize()
    assert pj.keys() == pt.keys() and int(pj["meta"][2]) >= 7
    for k in pj:
        np.testing.assert_array_equal(pt[k], pj[k], err_msg=k)


def test_track_pool_round_trips_between_packages():
    """A pool serialized by either package deserializes in the other to the
    same arrays (the .npz schema carries it)."""
    cfg = {"assignment": {"method": "assign_detections_greedy",
                          "max_distance": 1.0}, "max_missed": 3}
    frames = _scene(np.random.default_rng(55))
    tr = JaxTracker(len(frames), cfg, cap=32)
    for fnr, (clusters, centres, npts) in enumerate(frames):
        tr.next(fnr, clusters, centres, npts)
    data = tr.finish().serialize()
    back = JaxTrackPool.deserialize(TrackPool.deserialize(data).serialize())
    for k, v in back.serialize().items():
        np.testing.assert_array_equal(v, data[k], err_msg=k)
    pool = TrackPool.deserialize(data)
    assert [list(pool.steps(t)) for t in pool.valid_tracks()] == [
        list(tr.pool.steps(t)) for t in tr.pool.valid_tracks()]
