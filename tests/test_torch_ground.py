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


def _chained_inputs(seed=666):
    """tests/test_ground.py::test_chained_scan_equals_per_chunk_scans's
    inputs: 16 frames of a flat noisy ground and a low object."""
    rng = np.random.default_rng(seed)
    f, n = 16, 4096
    pts = np.zeros((f, n, 4), np.float32)
    for i in range(f):
        g = rng.uniform(-30, 30, (3000, 2))
        z = rng.normal(0.0, 0.05, 3000) - 1.7
        obj = rng.uniform(-10, 10, (500, 3)) * [1, 1, 0.1]
        pts[i, :3000, :2], pts[i, :3000, 2] = g, z
        pts[i, 3000:3500, :3] = obj + [0, 0, 0.5]
        pts[i, :, 3] = 0.5
    mask = np.zeros((f, n), bool)
    mask[:, :3500] = True
    return pts, mask


@pytest.mark.parametrize("chains", [2, 4])
def test_chained_scan_equals_per_chunk_scans(chains):
    """segment_sequence_chained's contract: the per-chunk full scans
    concatenated, exactly (each chunk with its own state and warm-up)."""
    pts, mask = _chained_inputs()
    cfg = tpw.GroundConfig(patch_capacity=256)
    p, m = torch.from_numpy(pts), torch.from_numpy(mask)
    chained = tpw.segment_sequence_chained(p, m, cfg, 0.0, chains).numpy()
    step = len(pts) // chains
    per_chunk = np.concatenate([
        tpw.segment_sequence(p[i:i + step], m[i:i + step], cfg, 0.0)[0].numpy()
        for i in range(0, len(pts), step)])
    np.testing.assert_array_equal(chained, per_chunk)
    assert chained.sum() > 0.5 * mask.sum()
    # the chunk heads are un-adapted: the single scan differs somewhere
    single = tpw.segment_sequence(p, m, cfg, 0.0)[0].numpy()
    np.testing.assert_array_equal(single[:step], chained[:step])


def test_chained_scan_equals_jax():
    """The port's chained scan against the JAX package's, chains = 4, on
    the verify scene's 16 frames on the 5 mm lattice (the inputs on which
    the two single scans agree, test_segment_sequence_masks_equal): masks
    equal."""
    pts, mask = _frames(32768, n_frames=16, seed=12, n_ground=3000,
                        n_vehicles=2, n_pedestrians=1, n_moving=1)
    gj = jpw.segment_sequence_chained(
        jnp.asarray(pts), jnp.asarray(mask),
        jpw.ground_config_from_cfg(jax_waymo_config(), min_range=1.5),
        1.723, chains=4)
    gt = tpw.segment_sequence_chained(
        torch.from_numpy(pts), torch.from_numpy(mask),
        tpw.ground_config_from_cfg(waymo_config(), min_range=1.5), 1.723, 4)
    np.testing.assert_array_equal(np.asarray(gj) & mask, gt.numpy() & mask)
    assert (gt.numpy() & mask).sum() > 0.25 * mask.sum()


def test_ground_stage_chains_match_jax():
    """``mask_ground_points`` with ``parallel.ground_chains`` = 3 on 24
    frames: the port's ground mask and non-ground buffers equal the JAX
    stage's (its single-device chained branch)."""
    from vilgod_tpu.data import SyntheticDataset as JaxSyntheticDataset
    from vilgod_tpu.pipeline.runner import ZeroShotDetector as JaxDetector
    from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector

    cap = {"max_points": 8192, "max_ng_points": 4096, "max_clusters": 32,
           "max_cluster_points": 1024, "max_tracks": 32,
           "max_cluster_input": 4096, "clip_batch": 4}
    scene = dict(n_sequences=1, n_frames=24, seed=7, n_ground=1500,
                 n_vehicles=2, n_pedestrians=1, n_moving=1, area=40.0)
    par = {"ground_chains": 3, "shard_frames": False, "shard_ground": False}
    zj = JaxDetector(JaxSyntheticDataset(**scene).sequence("synth_0"),
                     "synth_0", jax_waymo_config(
                         capacity=cap, pipeline_active=["mask_ground_points"],
                         parallel=par))
    zj.process()
    zt = ZeroShotDetector(SyntheticDataset(**scene).sequence("synth_0"),
                          "synth_0", waymo_config(
                              capacity=cap,
                              pipeline_active=["mask_ground_points"],
                              parallel={"ground_chains": 3}), device="cpu")
    zt.process()
    sj, st = zj.state, zt.state
    np.testing.assert_array_equal(np.asarray(sj.ground_mask), st.ground_mask)
    for name in ("ng_mask", "ng_src"):
        np.testing.assert_array_equal(np.asarray(getattr(sj, name)),
                                      getattr(st, name), err_msg=name)
    np.testing.assert_allclose(np.asarray(sj.ng_xyz), st.ng_xyz, atol=1e-5)
    np.testing.assert_array_equal(sj._ng_counts, st._ng_counts)
    # the chain heads differ from the single scan's (the default)
    single = ZeroShotDetector(SyntheticDataset(**scene).sequence("synth_0"),
                              "synth_0", waymo_config(
                                  capacity=cap,
                                  pipeline_active=["mask_ground_points"]),
                              device="cpu")
    single.process()
    np.testing.assert_array_equal(single.state.ground_mask[:8],
                                  st.ground_mask[:8])


def test_ring_sums_part_from_jax_off_the_lattice():
    """A standing difference (ROADMAP queue 3): the port sums the A-GLE
    ring statistics in float64 and rounds once, XLA in float32, and the
    adaptive elevation threshold can land one ulp apart. On
    tests/test_ground.py's chained-scan inputs (uniform floats, off the
    5 mm lattice) that flips a few points of frames 5-6 of the chunk that
    starts at frame 4; the lattice scenes above are equal bit for bit."""
    pts, mask = _chained_inputs(666)
    p, m = pts[4:8], mask[4:8]
    gj = np.asarray(jpw.segment_sequence(
        jnp.asarray(p), jnp.asarray(m), jpw.GroundConfig(patch_capacity=256),
        0.0)[0])
    gt = tpw.segment_sequence(torch.from_numpy(p), torch.from_numpy(m),
                              tpw.GroundConfig(patch_capacity=256),
                              0.0)[0].numpy()
    differ = np.argwhere(gj != gt)
    assert 0 < len(differ) <= 8, len(differ)
    assert set(differ[:, 0]) <= {1, 2}
    np.testing.assert_array_equal(gj[0], gt[0])
