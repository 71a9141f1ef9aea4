"""The port's ground segmentation (vilgod_tpu_torch/ground/patchwork.py)
against vilgod_tpu.ground.patchwork.segment_sequence on synthetic
sequences: the ground masks must be equal, frame by frame, with the
A-GLE/TGR state carried across frames."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vilgod_tpu.config.presets import waymo_config as jax_waymo_config
from vilgod_tpu.ground import patchwork as jpw
from vilgod_tpu_torch.config import waymo_config
from vilgod_tpu_torch.data import SyntheticDataset
from vilgod_tpu_torch.ground import patchwork as tpw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: one intra-op
    thread per worker keeps torch's thread pools from oversubscribing them
    (eight threads per worker made these tests ten times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(max_points, **scene):
    """Sensor-frame clouds on the pipeline's 5 mm int16 lattice."""
    seq = SyntheticDataset(n_sequences=1, **scene).sequence("synth_0")
    n_frames = seq.sequence_length
    pts = np.zeros((n_frames, max_points, 4), np.float32)
    mask = np.zeros((n_frames, max_points), bool)
    for f in range(n_frames):
        p = seq.get_lidar_points(f)[:max_points, :4]
        q = np.clip(np.rint(p / np.float32(0.005)), -32767, 32767)
        pts[f, :len(p)] = q.astype(np.int16).astype(np.float32) * np.float32(0.005)
        mask[f, :len(p)] = True
    return pts, mask


@pytest.mark.parametrize("scene", [
    dict(n_frames=16, seed=12, n_ground=3000, n_vehicles=2,
         n_pedestrians=1, n_moving=1),
    dict(n_frames=8, seed=7, n_ground=20000, n_vehicles=6, n_pedestrians=3,
         n_cyclists=2, n_moving=3, area=60.0),
], ids=["verify", "dense"])
def test_segment_sequence_masks_equal(scene):
    pts, mask = _frames(32768, **scene)
    gj, sj = jpw.segment_sequence(
        jnp.asarray(pts), jnp.asarray(mask),
        jpw.ground_config_from_cfg(jax_waymo_config(), min_range=1.5), 1.723)
    gt, st = tpw.segment_sequence(
        torch.from_numpy(pts), torch.from_numpy(mask),
        tpw.ground_config_from_cfg(waymo_config(), min_range=1.5), 1.723)
    gj = np.asarray(gj) & mask
    gt = gt.numpy() & mask
    np.testing.assert_array_equal(gj, gt)
    assert gt.sum() > 0.5 * mask.sum() * 0.5   # ground was found
    # the adaptive state carried to the end agrees too
    np.testing.assert_array_equal(np.asarray(sj.elev_cnt), st.elev_cnt.numpy())
    np.testing.assert_allclose(np.asarray(sj.sensor_height),
                               st.sensor_height.numpy(), rtol=1e-6)


def test_eigh3_smallest_matches_numpy():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(64, 3, 3))
    a = (a @ np.swapaxes(a, 1, 2)).astype(np.float32)
    evals, v = tpw._eigh3_smallest(torch.from_numpy(a))
    w, vecs = np.linalg.eigh(a.astype(np.float64))
    np.testing.assert_allclose(evals.numpy(), w, rtol=1e-3, atol=1e-4)
    # eigenvector up to sign
    dots = np.abs(np.sum(v.numpy() * vecs[:, :, 0], axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-3)
