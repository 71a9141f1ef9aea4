"""Stages 5 and 7-9 of the port (track_clusters, fit_bounding_boxes_simple,
propagate_labels, evaluate_sequence: vilgod_tpu_torch/pipeline/
stages_boxes.py) against vilgod_tpu on the verify scene, geometry-only.

JAX runs stages 1-4 and checkpoints them (.npz, its schema); then JAX and
the port each resume that checkpoint and run stages 5 and 7-9. Equal:
det_tid, det_valid, det_cls, det_static_track, the track pool and the
per-frame result lengths and names; det_box within 1e-4 m (XLA's own
float32 cosine, ROADMAP faults); the port's evaluate_detections APs equal
JAX's on the same results within 1e-6. Also the .npz round trip of the
tracks, and the nine-stage registry."""
import shutil

import numpy as np
import pytest
import torch

from vilgod_tpu.config.presets import waymo_config as jax_waymo_config
from vilgod_tpu.data import SyntheticDataset as JaxSyntheticDataset
from vilgod_tpu.eval import evaluate_detections as jax_evaluate_detections
from vilgod_tpu.pipeline.runner import STAGE_REGISTRY as JAX_STAGES
from vilgod_tpu.pipeline.runner import ZeroShotDetector as JaxDetector
from vilgod_tpu_torch.config import waymo_config
from vilgod_tpu_torch.data import SyntheticDataset
from vilgod_tpu_torch.eval import evaluate_detections
from vilgod_tpu_torch.pipeline.runner import STAGE_REGISTRY, ZeroShotDetector
from vilgod_tpu_torch.pipeline.state import Capacity, SequenceState


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CAP = {"max_points": 16384, "max_ng_points": 8192, "max_clusters": 64,
       "max_cluster_points": 4096, "max_tracks": 64,
       "max_cluster_input": 8192, "clip_batch": 8}
GEOMETRY = ["mask_ground_points", "calculate_entropy_scores",
            "spatial_clustering", "filter_detections"]
BOXES = ["track_clusters", "fit_bounding_boxes_simple", "propagate_labels",
         "evaluate_sequence"]
SCENE = dict(n_sequences=1, n_frames=16, seed=12, n_ground=3000,
             n_vehicles=2, n_pedestrians=1, n_moving=1)
PARALLEL = {"shard_frames": False, "shard_ground": False,
            "shard_cluster": False, "shard_filter": False,
            "shard_clip": False}
EVAL_RANGE = (-50.0, -20.0, 50.0, 20.0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX detector, port detector, the port's checkpoint dir), both after
    stages 5 and 7-9 over JAX's stage 1-4 checkpoint."""
    base = tmp_path_factory.mktemp("boxes")
    jcache, tcache = base / "jax", base / "port"
    JaxDetector(JaxSyntheticDataset(**SCENE).sequence("synth_0"), "synth_0",
                jax_waymo_config(capacity=CAP, pipeline_active=GEOMETRY,
                                 parallel=PARALLEL),
                cache_dir=jcache).process()
    tcache.mkdir()
    shutil.copy(jcache / "synth_0.npz", tcache / "synth_0.npz")
    zj = JaxDetector(JaxSyntheticDataset(**SCENE).sequence("synth_0"),
                     "synth_0",
                     jax_waymo_config(capacity=CAP,
                                      pipeline_active=GEOMETRY + BOXES,
                                      parallel=PARALLEL), cache_dir=jcache)
    zj.process()
    zt = ZeroShotDetector(SyntheticDataset(**SCENE).sequence("synth_0"),
                          "synth_0", waymo_config(
                              capacity=CAP, pipeline_active=GEOMETRY + BOXES),
                          cache_dir=tcache, device="cpu")
    zt.process()
    return zj, zt, tcache


def test_box_stages_match_jax(runs):
    zj, zt, _ = runs
    j, t = zj.state, zt.state
    assert set(zt.stage_times) == set(GEOMETRY + BOXES)
    assert max(zt.stage_times[s] for s in GEOMETRY) < 0.5   # resumed
    for name in ("det_tid", "det_valid", "det_cls", "det_static_track"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    np.testing.assert_array_equal(np.isnan(t.det_box), np.isnan(j.det_box))
    np.testing.assert_allclose(t.det_box, j.det_box, atol=1e-4, rtol=0)
    np.testing.assert_allclose(t.det_score, j.det_score, atol=1e-6, rtol=0)
    pj, pt = j.tracks.serialize(), t.tracks.serialize()
    for k in pj:
        np.testing.assert_array_equal(pt[k], pj[k], err_msg=k)
    # the scene's objects are tracked and boxed
    assert len(j.tracks.valid_tracks()) >= 3
    assert (j.det_valid & ~np.isnan(j.det_box[..., 0])).sum() >= 30


def test_results_and_aps_match_jax(runs):
    zj, zt, _ = runs
    rj, rt = zj.detection_3d_result_list, zt.detection_3d_result_list
    assert len(rt) == len(rj) == SCENE["n_frames"]
    for a, b in zip(rt, rj):
        assert len(a["name"]) == len(b["name"])
        np.testing.assert_array_equal(a["name"], b["name"])
        np.testing.assert_array_equal(a["moving"], b["moving"])
        np.testing.assert_allclose(a["boxes_lidar"], b["boxes_lidar"],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(a["score"], b["score"], atol=1e-6, rtol=0)
    assert sum(len(r["name"]) for r in rj) >= 20
    seq = JaxSyntheticDataset(**SCENE).sequence("synth_0")
    gt = [seq.get_annos(f) for f in range(SCENE["n_frames"])]
    want = jax_evaluate_detections(rj, gt, eval_range=EVAL_RANGE)
    got = evaluate_detections(rt, gt, eval_range=EVAL_RANGE)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert want["OBJECT_TYPE_TYPE_VEHICLE_LEVEL_2/AP"] > 0.3


def test_tracks_round_trip_through_npz(runs):
    """The port's checkpoint after stage 9 carries the track pool and the
    per-detection track ids, boxes and flags; the JAX package reads it."""
    from vilgod_tpu.pipeline.state import Capacity as JaxCapacity
    from vilgod_tpu.pipeline.state import SequenceState as JaxSequenceState

    _, zt, tcache = runs
    t = zt.state
    caps = Capacity.from_cfg(waymo_config(capacity=CAP))
    back = SequenceState.allocate("synth_0", t.n_frames, caps, device="cpu")
    assert back.load(tcache / "synth_0.npz")
    j = JaxSequenceState.allocate("synth_0", t.n_frames,
                                  JaxCapacity.from_cfg({"capacity": CAP}))
    assert j.load(tcache / "synth_0.npz")
    for st in (back, j):
        for name in ("det_tid", "det_static_track", "det_valid", "det_cls"):
            np.testing.assert_array_equal(getattr(st, name),
                                          getattr(t, name), err_msg=name)
        np.testing.assert_array_equal(st.det_box, t.det_box)
        for k, v in t.tracks.serialize().items():
            np.testing.assert_array_equal(st.tracks.serialize()[k], v,
                                          err_msg=k)
    assert set(BOXES[:3]) <= set(back.done)   # stage 9 exports only


def test_all_nine_stages_registered():
    """The port's registry holds every stage of the JAX pipeline."""
    assert set(STAGE_REGISTRY) == set(JAX_STAGES)
    assert len(STAGE_REGISTRY) == 9
