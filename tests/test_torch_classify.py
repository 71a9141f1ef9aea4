"""The five-stage slice (mask_ground_points -> calculate_entropy_scores ->
spatial_clustering -> filter_detections -> classification) on the verify
scene, device="cpu", against the JAX package with the same CLIP weights
(tests/test_classification.py's SMALL_CLIP in f32, the JAX tree carried
across): equal valid flags and classes, scores within 1e-4.

JAX runs all five stages; the port runs stages 4 and 5 through its runner
over JAX's own stage 1-3 buffers (tests/test_torch_slice.py holds the
port's stages 1-3 to JAX's on this scene, and a port run of all five
stages on the CPU takes minutes with one thread). Also the view vote, the
clip_model pass-through of ZeroShotDetector, and the cluster tables
rebuilt after an .npz resume."""
import numpy as np
import pytest
import torch
import jax

from vilgod_tpu.config.presets import waymo_config as jax_waymo_config
from vilgod_tpu.data import SyntheticDataset as JaxSyntheticDataset
from vilgod_tpu.models.clip import CLIPConfig as JaxCLIPConfig
from vilgod_tpu.models.clip_wrapper import ClipWrapper as JaxClipWrapper
from vilgod_tpu.pipeline.runner import ZeroShotDetector as JaxDetector
from vilgod_tpu_torch.config import waymo_config
from vilgod_tpu_torch.data import SyntheticDataset
from vilgod_tpu_torch.models.clip import CLIPConfig, params_from_jax
from vilgod_tpu_torch.models.clip_wrapper import ClipWrapper
from vilgod_tpu_torch.pipeline import CLS_NONE, MAPPED_CLASSES
from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector
from vilgod_tpu_torch.pipeline.stages_classify import _vote
from vilgod_tpu_torch.pipeline.stages_geometry import (frame_bucket,
                                                       rebuild_ng_buffers)


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
STAGES = ["mask_ground_points", "calculate_entropy_scores",
          "spatial_clustering", "filter_detections", "classification"]
SCENE = dict(n_sequences=1, n_frames=16, seed=12, n_ground=3000,
             n_vehicles=2, n_pedestrians=1, n_moving=1)
SMALL = dict(image_size=224, patch_size=32, vision_width=64, vision_layers=2,
             vision_heads=2, embed_dim=32, context_length=77,
             vocab_size=49408, text_width=32, text_heads=2, text_layers=2)
# the single-device JAX paths are the ones the port mirrors
PARALLEL = {"shard_frames": False, "shard_ground": False,
            "shard_cluster": False, "shard_filter": False,
            "shard_clip": False}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX state, port detector, its checkpoint dir) after the five
    stages with the same weights."""
    jcfg = jax_waymo_config(capacity=CAP, pipeline_active=STAGES,
                            parallel=PARALLEL)
    clip_cfg = jcfg["preprocessor"]["clip"]
    jw = JaxClipWrapper(clip_cfg, model_cfg=JaxCLIPConfig(**SMALL))
    zj = JaxDetector(JaxSyntheticDataset(**SCENE).sequence("synth_0"),
                     "synth_0", jcfg, clip_model=jw)
    zj.process()
    j = zj.state

    tc = CLIPConfig(**SMALL)
    tw = ClipWrapper(clip_cfg, model_cfg=tc, device="cpu",
                     model=params_from_jax(jax.tree.map(np.asarray,
                                                        jw.params), tc,
                                           device="cpu"))
    cache = tmp_path_factory.mktemp("classify")
    cfg = waymo_config(capacity=CAP, pipeline_active=STAGES)
    zt = ZeroShotDetector(SyntheticDataset(**SCENE).sequence("synth_0"),
                          "synth_0", cfg, clip_model=tw, cache_dir=cache,
                          device="cpu")
    t = zt.state
    for name in ("ground_mask", "labels", "probs", "ng_entropy"):
        getattr(t, "_h_" + name)[...] = getattr(j, name)
    for name in ("det_n", "det_center", "det_static"):
        getattr(t, name)[...] = getattr(j, name)
    t.det_valid[...] = t.det_n > 0
    t.done.update({s: True for s in STAGES[:3]})
    t._dev.clear()
    t._canon.clear()
    rebuild_ng_buffers(t)
    zt.process()
    return j, zt, cache


def test_five_stage_slice_matches_jax(runs):
    j, zt, _ = runs
    t = zt.state
    assert set(zt.stage_times) == set(STAGES)
    assert j.det_valid.sum(axis=1).min() >= 3   # the scene's objects
    np.testing.assert_allclose(t.plane_ref, j.plane_ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t.det_valid, j.det_valid)
    np.testing.assert_array_equal(t.det_cls, j.det_cls)
    np.testing.assert_allclose(t.det_score, j.det_score, atol=1e-4, rtol=0)


def test_detector_passes_clip_model_to_classification(runs):
    """ZeroShotDetector(..., clip_model=...) classifies every valid
    detection and leaves the others unset."""
    _, zt, _ = runs
    t = zt.state
    valid = t.det_valid
    assert valid.sum() > 0
    assert (t.det_cls[valid] != CLS_NONE).all()
    assert ((t.det_cls[valid] >= 0)
            & (t.det_cls[valid] < len(MAPPED_CLASSES))).all()
    assert ((t.det_score[valid] > 0) & (t.det_score[valid] <= 1)).all()
    assert (t.det_cls[~valid] == CLS_NONE).all()


def test_det_tables_rebuilt_after_resume(runs):
    """After an .npz resume the gather tables rebuild from the labels and
    equal the ones the run built; a resumed run skips every finished
    stage."""
    _, zt, cache = runs
    st = zt.state
    f_pad, n_ng = frame_bucket(st.n_frames), st.ng_bucket()
    tables, masks = st.det_tables(f_pad, n_ng)
    cfg = waymo_config(capacity=CAP, pipeline_active=STAGES)
    resumed = ZeroShotDetector(SyntheticDataset(**SCENE).sequence("synth_0"),
                               "synth_0", cfg, cache_dir=cache, device="cpu")
    assert ("det_tables", f_pad, n_ng) not in resumed.state._dev
    t2, m2 = resumed.state.det_tables(f_pad, n_ng)
    assert torch.equal(t2, tables) and torch.equal(m2, masks)
    np.testing.assert_array_equal(resumed.state.det_cls, st.det_cls)
    resumed.process()   # every stage done: nothing reruns
    assert max(resumed.stage_times.values()) < 1.0


@pytest.mark.parametrize("names,scores,want_name,want_score", [
    # clear majority: the mean over that class's views
    (["Vehicle", "Vehicle", "Vehicle", "Background"], [0.8, 0.6, 0.7, 0.9],
     "Vehicle", 0.7),
    # tie: the highest per-class mean wins
    (["Vehicle", "Vehicle", "Background", "Background"], [0.4, 0.4, 0.9, 0.5],
     "Background", 0.7),
], ids=["majority", "tie"])
def test_vote_aggregation_rules(names, scores, want_name, want_score):
    name, score = _vote(names, np.array(scores))
    assert name == want_name and score == pytest.approx(want_score)
