"""The port's ``tools/debug_cluster_crash`` at a small size on the CPU:
stages 1-3 through the port's ``ZeroShotDetector`` against the JAX
package's on the same small scene and caps (``ng_bucket``, the valid
detections and ``labels_max`` equal), and the tool's ``main`` with
``--device cpu``."""
import pytest
import torch

from vilgod_tpu.config.presets import waymo_config as jax_waymo_config
from vilgod_tpu.data import SyntheticDataset as JaxSyntheticDataset
from vilgod_tpu.pipeline.runner import ZeroShotDetector as JaxDetector
from vilgod_tpu_torch.tools import debug_cluster_crash

# a cluster input of 4096 points a frame: the banded per-frame clustering
CAPS = {"max_points": 16384, "max_ng_points": 8192, "max_clusters": 64,
        "max_cluster_points": 2048, "max_tracks": 64,
        "max_cluster_input": 4096, "clip_batch": 8}
SCENE = dict(n_ground=2500, n_vehicles=2, n_pedestrians=1, n_moving=1,
             area=50.0)
FRAMES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_debug_cluster_crash_matches_jax():
    out = debug_cluster_crash.run(FRAMES, "cpu", CAPS, SCENE)
    assert list(out["stage_s"]) == debug_cluster_crash.STAGES
    # the single-device JAX paths are the ones the port mirrors
    par = {"shard_frames": False, "shard_ground": False,
           "shard_cluster": False}
    cfg = jax_waymo_config(capacity=CAPS,
                           pipeline_active=debug_cluster_crash.STAGES,
                           parallel=par)
    zsd = JaxDetector(JaxSyntheticDataset(
        n_sequences=1, n_frames=FRAMES, seed=debug_cluster_crash.SEED,
        **SCENE).sequence("synth_0"), "synth_0", cfg)
    zsd.process()
    st = zsd.state
    assert out["ng_bucket"] == st.ng_bucket()
    assert out["dets"] == int(st.det_valid.sum()) and out["dets"] > 0
    assert out["labels_max"] == int(st.labels.max()) and out["labels_max"] > 0


def test_main_on_the_cpu(capsys):
    assert debug_cluster_crash.main(["--device", "cpu", "--smoke",
                                     "--frames", "8"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu" and lines[-1].startswith("# OK in ")
