"""The port's entropy scores (vilgod_tpu_torch/ops/entropy.py) against
vilgod_tpu.ops.entropy.entropy_sequence on the same non-ground buffers:
scores within 1e-6 (the counts are exact; the log and the division may
round differently)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vilgod_tpu.config.presets import waymo_config as jax_waymo_config
from vilgod_tpu.data import SyntheticDataset as JaxSyntheticDataset
from vilgod_tpu.ops.entropy import entropy_from_counts as jax_from_counts
from vilgod_tpu.ops.entropy import entropy_sequence as jax_entropy
from vilgod_tpu.pipeline.runner import ZeroShotDetector as JaxDetector
from vilgod_tpu.pipeline.stages_geometry import frame_bucket
from vilgod_tpu_torch.ops.entropy import entropy_from_counts, entropy_sequence


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


@pytest.fixture(scope="module")
def jax_ng():
    """The verify scene's non-ground buffers from the JAX stage 1."""
    cfg = jax_waymo_config(capacity=CAP, pipeline_active=["mask_ground_points"])
    ds = JaxSyntheticDataset(n_sequences=1, n_frames=12, seed=12,
                             n_ground=3000, n_vehicles=2, n_pedestrians=1,
                             n_moving=1)
    zsd = JaxDetector(ds.sequence("synth_0"), "synth_0", cfg)
    zsd.process()
    st = zsd.state
    f_pad, n_ng, n_pts = frame_bucket(st.n_frames), st.ng_bucket(), st.points_bucket()
    fv = np.zeros(f_pad, bool)
    fv[:st.n_frames] = True
    return dict(xyz=np.array(st.device("ng_xyz", f_pad, n_ng)),
                mask=np.array(st.device("ng_mask", f_pad, n_ng)),
                fv=fv,
                pts=np.array(st.device("points", f_pad, n_pts)[..., :3]),
                pmask=np.array(st.device("points_mask", f_pad, n_pts)))


def _both(frames, masks, fv, **kw):
    j = np.asarray(jax_entropy(jnp.asarray(frames), jnp.asarray(masks),
                               jnp.asarray(fv), **{
                                   k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                                   for k, v in kw.items()}))
    t = entropy_sequence(torch.from_numpy(frames), torch.from_numpy(masks),
                         torch.from_numpy(fv), **{
                             k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                             for k, v in kw.items()}).numpy()
    return j, t


@pytest.mark.parametrize("window,skip", [(15, 1), (4, 0)])
def test_entropy_sequence_matches(jax_ng, window, skip):
    j, t = _both(jax_ng["xyz"], jax_ng["mask"], jax_ng["fv"], window=window,
                 skip_frames=skip)
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    assert (t[jax_ng["mask"]] < 0.6).mean() > 0.01  # a mover is found


def test_entropy_include_ground_points(jax_ng):
    """The neighbour window holds the full cloud (world frame)."""
    j, t = _both(jax_ng["xyz"], jax_ng["mask"], jax_ng["fv"],
                 data_frames=jax_ng["pts"], data_masks=jax_ng["pmask"])
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)


def test_entropy_window_overflow_full_width():
    """A dense pile overflows the band: both re-run at full width."""
    rng = np.random.default_rng(11)
    f, n = 4, 8192
    frames = rng.uniform(-20, 20, (f, n, 3)).astype(np.float32)
    frames[:, :5000, :2] = rng.normal(0, 0.05, (f, 5000, 2))
    frames = np.round(frames / 0.005).astype(np.float32) * np.float32(0.005)
    masks = np.ones((f, n), bool)
    masks[:, -100:] = False
    j, t = _both(frames, masks, np.ones(f, bool), window=4, skip_frames=0)
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)


def test_entropy_from_counts():
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 40, (1000, 8)).astype(np.int32)
    counts[:10] = 0
    np.testing.assert_allclose(
        entropy_from_counts(torch.from_numpy(counts)).numpy(),
        np.asarray(jax_from_counts(jnp.asarray(counts))), atol=1e-6, rtol=0)
