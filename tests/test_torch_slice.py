"""The port's three-stage slice (mask_ground_points ->
calculate_entropy_scores -> spatial_clustering) on the verify scene,
device="cpu", against the JAX package; the shared .npz checkpoint schema;
and that the port runs with jax unimportable."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vilgod_tpu.config.presets import waymo_config as jax_waymo_config
from vilgod_tpu.data import SyntheticDataset as JaxSyntheticDataset
from vilgod_tpu.pipeline.runner import ZeroShotDetector as JaxDetector
from vilgod_tpu_torch.config import waymo_config
from vilgod_tpu_torch.data import SyntheticDataset
from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector, run_sequences
from vilgod_tpu_torch.pipeline.state import Capacity, SequenceState


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: one intra-op
    thread per worker keeps torch's thread pools from oversubscribing them
    (eight threads per worker made these tests ten times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CAP = {"max_points": 16384, "max_ng_points": 8192, "max_clusters": 64,
       "max_cluster_points": 4096, "max_tracks": 64,
       "max_cluster_input": 8192, "clip_batch": 8}
STAGES = ["mask_ground_points", "calculate_entropy_scores",
          "spatial_clustering"]
SCENE = dict(n_sequences=1, n_frames=16, seed=12, n_ground=3000,
             n_vehicles=2, n_pedestrians=1, n_moving=1)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_state():
    # the single-device JAX paths are the ones the port mirrors
    par = {"shard_frames": False, "shard_ground": False,
           "shard_cluster": False}
    cfg = jax_waymo_config(capacity=CAP, pipeline_active=STAGES, parallel=par)
    zsd = JaxDetector(JaxSyntheticDataset(**SCENE).sequence("synth_0"),
                      "synth_0", cfg)
    zsd.process()
    return zsd.state


def test_slice_matches_jax_on_verify_scene(jax_state, tmp_path):
    cfg = waymo_config(capacity=CAP, pipeline_active=STAGES)
    times = {}
    run_sequences(SyntheticDataset(**SCENE), cfg, cache_dir=tmp_path,
                  stage_times=times, device="cpu")
    assert set(times) == set(STAGES)
    # the run's checkpoint is the port's state after the three stages
    t = SequenceState.allocate("synth_0", 16, Capacity.from_cfg(cfg),
                               device="cpu")
    assert t.load(tmp_path / "synth_0.npz")
    j = jax_state
    np.testing.assert_array_equal(j.ground_mask, t.ground_mask)
    np.testing.assert_array_equal(j.det_n, t.det_n)
    np.testing.assert_array_equal(j.det_static, t.det_static)
    np.testing.assert_array_equal(j.labels, t.labels)
    np.testing.assert_allclose(t.det_center, j.det_center, atol=1e-4, rtol=0)
    # the checkpoint keeps entropy below 0.9 only (the reference's format)
    np.testing.assert_allclose(t.ng_entropy, np.where(j.ng_entropy < 0.9,
                                                      j.ng_entropy, 1.0),
                               atol=1e-6, rtol=0)
    assert (t.det_n > 0).sum(axis=1).min() >= 3  # the scene's objects


def test_jax_checkpoint_loads_into_port(jax_state, tmp_path):
    """The checkpoint schema is shared: a JAX-written .npz resumes in the
    port (stages marked done, ng buffers rebuilt from the raw frames)."""
    jax_state.save(tmp_path / "synth_0.npz")
    cfg = waymo_config(capacity=CAP, pipeline_active=STAGES)
    zsd = ZeroShotDetector(SyntheticDataset(**SCENE).sequence("synth_0"),
                           "synth_0", cfg, cache_dir=tmp_path, device="cpu")
    st = zsd.state
    assert set(STAGES) <= set(st.done)
    np.testing.assert_array_equal(st.ground_mask, jax_state.ground_mask)
    np.testing.assert_array_equal(st.det_n, jax_state.det_n)
    np.testing.assert_array_equal(st.labels, jax_state.labels)
    # rebuilt from raw frames + loaded ground masks
    np.testing.assert_array_equal(st.ng_mask, jax_state.ng_mask)
    np.testing.assert_array_equal(st.ng_xyz, jax_state.ng_xyz)
    zsd.process()  # every stage is done: nothing reruns
    assert zsd.stage_times["spatial_clustering"] < 1.0


def test_port_runs_without_jax(tmp_path):
    """vilgod_tpu_torch never imports jax: with jax unimportable the
    package (the CLIP models, the classification and box stages, tracking,
    eval, the dense kernels, the dataset adapters and export, the run tool,
    the evaluate tool, the bench, the multi-device layer, the native
    ground oracle and the debug tools included) imports and runs a stage;
    asking for cuda without a card raises."""
    code = """
import sys
sys.modules["jax"] = None
import torch
from vilgod_tpu_torch.config import waymo_config
from vilgod_tpu_torch.data import SyntheticDataset
from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector
import vilgod_tpu_torch.models
from vilgod_tpu_torch.models import clip, clip_wrapper, tokenizer, vit_kernels
from vilgod_tpu_torch.pipeline import stages_boxes, stages_classify
from vilgod_tpu_torch import eval, tracking
from vilgod_tpu_torch.ops import boxes, dense_kernels
from vilgod_tpu_torch.tools import bench, evaluate, run
from vilgod_tpu_torch import ground, ops, parallel, utils
from vilgod_tpu_torch.data import argoverse, export, openpcdet, waymo
from vilgod_tpu_torch.eval import sequence_eval, waymo_tf
from vilgod_tpu_torch.ground import native
from vilgod_tpu_torch.tools import (debug_band_width, debug_cluster_crash,
                                    debug_cluster_stepwise,
                                    debug_ground_scale, debug_soak_cluster,
                                    ground_oracle)
cap = {"max_points": 16384, "max_ng_points": 8192, "max_cluster_input": 8192}
cfg = waymo_config(capacity=cap, pipeline_active=["mask_ground_points"])
seq = SyntheticDataset(n_sequences=1, n_frames=4, seed=12, n_ground=3000,
                       n_vehicles=2).sequence("synth_0")
zsd = ZeroShotDetector(seq, "synth_0", cfg, device="cpu")
zsd.process()
assert zsd.state.ground_mask.sum() > 1000
if not torch.cuda.is_available():
    try:
        ZeroShotDetector(seq, "synth_0", cfg)
    except RuntimeError:
        pass
    else:
        raise SystemExit("no card, yet the default device did not raise")
assert not any(m == "jax" or m.startswith(("jax.", "vilgod_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("OK")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("OK")


@pytest.mark.parametrize("chains,want", [(3, 3), (5, 1)],
                         ids=["ground-chains", "ground-chains-fallback"])
def test_unported_stage_raises(chains, want, monkeypatch):
    """No branch of the port raises where the JAX package's runs: the last
    one that did, ``parallel.ground_chains`` (a NotImplementedError until
    the chained scan was ported), now runs the chained scan under the JAX
    package's gate. On 24 frames k = 3 runs three chains of 8 frames; k = 5
    does not divide 24 and falls back to the single scan. The stage's mask
    is the scan's it took."""
    from vilgod_tpu_torch.ground import patchwork
    from vilgod_tpu_torch.pipeline import stages_geometry

    taken = []

    def spy(fn):
        def run(*args, **kw):
            taken.append(fn.__name__)
            out = fn(*args, **kw)
            taken.append(out[0] if isinstance(out, tuple) else out)
            return out
        return run

    for name in ("segment_sequence", "segment_sequence_chained"):
        monkeypatch.setattr(stages_geometry, name,
                            spy(getattr(patchwork, name)))
    cap = {**CAP, "max_points": 8192, "max_ng_points": 4096}
    cfg = waymo_config(capacity=cap, pipeline_active=["mask_ground_points"],
                       parallel={"ground_chains": chains})
    assert stages_geometry.ground_chains(cfg, 24) == want
    zsd = ZeroShotDetector(SyntheticDataset(
        n_sequences=1, n_frames=24, seed=12, n_ground=1200,
        n_vehicles=1).sequence("synth_0"), "synth_0", cfg, device="cpu")
    zsd.process()
    assert taken[0] == ("segment_sequence_chained" if want > 1
                        else "segment_sequence")
    assert len(taken) == 2
    ground = zsd.state.ground_mask
    mask = zsd.state.points_mask
    np.testing.assert_array_equal(
        ground, (taken[1].numpy() & zsd.state.device(
            "points_mask", 24, ground.shape[1]).numpy())[:24])
    assert ground[mask].any()
