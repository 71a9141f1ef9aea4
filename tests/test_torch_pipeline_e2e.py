"""Parity of the port's nine stages end to end with the JAX package's.

``ZeroShotDetector`` of each package runs all nine stages of the main path
(ground -> entropy -> clustering -> filter -> tracking -> classification
-> boxes -> label propagation -> evaluation) on the same synthetic scene,
the port on the CPU, each classifying with tests/test_classification.py's
``SMALL_CLIP`` in f32 (the JAX tree carried across by
``models/clip.params_from_jax``). Equal: det_n, det_valid, det_cls,
det_tid, the track pool, the per-frame result lengths and names. Within
tolerance: det_center 1e-4 m, det_score 1e-4, det_box and the exported
boxes 1e-4 m, LEVEL_2 APs 1e-6.

The smoke scene of tests/test_pipeline_e2e.py (6 frames, seed 11, 900
ground points, its caps) runs in tier 1; its 18-frame seed-3 scene is
marked slow, as JAX's own tests on it are. Also slow: the geometry-only
stages (no CLIP model: the classes come from the size prior) on the
bench's 24-frame parity scene at its full caps
(``vilgod_tpu_torch/tools/scenes.py``), where both packages must give the
same boxes and LEVEL_2 APs; ``chip_smoke.py`` prints the port's on the
card."""
import numpy as np
import pytest
import torch
import jax

from vilgod_tpu.config.presets import waymo_config as jax_waymo_config
from vilgod_tpu.data import SyntheticDataset as JaxSyntheticDataset
from vilgod_tpu.eval import evaluate_detections as jax_evaluate_detections
from vilgod_tpu.models.clip import CLIPConfig as JaxCLIPConfig
from vilgod_tpu.models.clip_wrapper import ClipWrapper as JaxClipWrapper
from vilgod_tpu.pipeline.runner import ZeroShotDetector as JaxDetector
from vilgod_tpu_torch.config import waymo_config
from vilgod_tpu_torch.data import SyntheticDataset
from vilgod_tpu_torch.eval import evaluate_detections
from vilgod_tpu_torch.models.clip import CLIPConfig, params_from_jax
from vilgod_tpu_torch.models.clip_wrapper import ClipWrapper
from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector
from vilgod_tpu_torch.tools import scenes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STAGES = ["mask_ground_points", "calculate_entropy_scores",
          "spatial_clustering", "filter_detections", "track_clusters",
          "classification", "fit_bounding_boxes_simple", "propagate_labels",
          "evaluate_sequence"]
# tests/test_classification.py's SMALL_CLIP, f32
SMALL = dict(image_size=224, patch_size=32, vision_width=64, vision_layers=2,
             vision_heads=2, embed_dim=32, context_length=77,
             vocab_size=49408, text_width=32, text_heads=2, text_layers=2)
# the single-device JAX paths are the ones the port mirrors
PARALLEL = {"shard_frames": False, "shard_ground": False,
            "shard_cluster": False, "shard_filter": False,
            "shard_clip": False}
EVAL_RANGE = (-50.0, -20.0, 50.0, 20.0)
# tests/test_pipeline_e2e.py: test_smoke_e2e's scene and caps, and the
# slow tier's fixture scene and caps
SMOKE = (dict(n_sequences=1, n_frames=6, seed=11, n_ground=900,
              n_vehicles=1, n_pedestrians=0, n_moving=0),
         {"max_points": 4096, "max_ng_points": 2048, "max_clusters": 16,
          "max_cluster_points": 512, "max_tracks": 16,
          "max_cluster_input": 2048, "clip_batch": 4})
FULL = (dict(n_sequences=1, n_frames=18, seed=3, n_ground=3000,
             n_vehicles=2, n_pedestrians=1, n_moving=1),
        {"max_points": 16384, "max_ng_points": 8192, "max_clusters": 64,
         "max_cluster_points": 4096, "max_tracks": 64,
         "max_cluster_input": 8192, "clip_batch": 8})


def _run_both(scene, caps):
    """(JAX detector, port detector) after the nine stages on ``scene``
    with the same CLIP weights."""
    jcfg = jax_waymo_config(capacity=caps, pipeline_active=STAGES,
                            parallel=PARALLEL)
    clip_cfg = jcfg["preprocessor"]["clip"]
    jw = JaxClipWrapper(clip_cfg, model_cfg=JaxCLIPConfig(**SMALL))
    zj = JaxDetector(JaxSyntheticDataset(**scene).sequence("synth_0"),
                     "synth_0", jcfg, clip_model=jw)
    zj.process()

    tc = CLIPConfig(**SMALL)
    tw = ClipWrapper(clip_cfg, model_cfg=tc, device="cpu",
                     model=params_from_jax(jax.tree.map(np.asarray,
                                                        jw.params), tc,
                                           device="cpu"))
    zt = ZeroShotDetector(SyntheticDataset(**scene).sequence("synth_0"),
                          "synth_0", waymo_config(capacity=caps,
                                                  pipeline_active=STAGES),
                          clip_model=tw, device="cpu")
    zt.process()
    return zj, zt


def _assert_results_match(rt, rj, scene):
    """Per-frame names equal, boxes and scores within 1e-4, and every
    LEVEL_2 metric within 1e-6 against the scene's ground truth; returns
    JAX's metrics."""
    assert len(rt) == len(rj) == scene["n_frames"]
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a["name"], b["name"])
        np.testing.assert_allclose(a["boxes_lidar"], b["boxes_lidar"],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(a["score"], b["score"], atol=1e-4, rtol=0)
    seq = JaxSyntheticDataset(**scene).sequence("synth_0")
    gt = [seq.get_annos(f) for f in range(scene["n_frames"])]
    want = jax_evaluate_detections(rj, gt, eval_range=EVAL_RANGE)
    got = evaluate_detections(rt, gt, eval_range=EVAL_RANGE)
    assert got.keys() == want.keys()
    for k in want:
        if "LEVEL_2" in k:
            assert got[k] == pytest.approx(want[k], abs=1e-6), k
    return want


def _assert_nine_stage_parity(zj, zt, scene):
    j, t = zj.state, zt.state
    assert set(zt.stage_times) == set(STAGES)
    for name in ("det_n", "det_valid", "det_cls", "det_tid"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    pj, pt = j.tracks.serialize(), t.tracks.serialize()
    assert pt.keys() == pj.keys()
    for k in pj:
        np.testing.assert_array_equal(pt[k], pj[k], err_msg=k)
    np.testing.assert_allclose(t.det_center, j.det_center, atol=1e-4, rtol=0)
    np.testing.assert_allclose(t.det_score, j.det_score, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np.isnan(t.det_box), np.isnan(j.det_box))
    np.testing.assert_allclose(t.det_box, j.det_box, atol=1e-4, rtol=0)

    _assert_results_match(zt.detection_3d_result_list,
                          zj.detection_3d_result_list, scene)
    # the check has teeth: the scene's objects are detected, classified
    # and tracked
    assert j.det_valid.sum() >= scene["n_frames"]
    assert len(j.tracks.valid_tracks()) >= 1


def test_nine_stages_match_jax_on_smoke_scene():
    scene, caps = SMOKE
    zj, zt = _run_both(scene, caps)
    _assert_nine_stage_parity(zj, zt, scene)


@pytest.mark.slow
def test_nine_stages_match_jax_on_e2e_scene():
    scene, caps = FULL
    zj, zt = _run_both(scene, caps)
    _assert_nine_stage_parity(zj, zt, scene)
    assert len(zj.state.tracks.valid_tracks()) >= 3


@pytest.mark.slow
def test_geometry_only_aps_match_jax_on_parity_scene():
    scene, caps = scenes.SCENE, scenes.CAPS
    jcfg = jax_waymo_config(capacity=caps, pipeline_active=scenes.STAGES,
                            parallel=PARALLEL)
    rj = JaxDetector(JaxSyntheticDataset(**scene).sequence("synth_0"),
                     "synth_0", jcfg).process()
    rt = ZeroShotDetector(SyntheticDataset(**scene).sequence("synth_0"),
                          "synth_0", waymo_config(
                              capacity=caps, pipeline_active=scenes.STAGES),
                          device="cpu").process()
    want = _assert_results_match(rt, rj, scene)
    # the check has teeth: all three classes are boxed, and the vehicles
    # and cyclists scored
    names = np.concatenate([r["name"] for r in rj])
    assert set(names) == {"Vehicle", "Pedestrian", "Cyclist"}
    assert want["OBJECT_TYPE_TYPE_VEHICLE_LEVEL_2/AP"] > 0.3
    assert want["OBJECT_TYPE_TYPE_CYCLIST_LEVEL_2/AP"] > 0.3
