"""The port's single-frame ground segmentation
(``vilgod_tpu_torch.ground.segment_ground``) against the C++ Patchwork++
oracle on tests/test_ground_native.py's scenes and bounds, against the
JAX package's ``segment_ground`` (masks, state and aux), and against one
step of the port's own ``segment_sequence``; the port's own oracle
(``vilgod_tpu_torch.ground.native``) on that file's four cases, equal bit
for bit to the JAX package's, and built at once by two processes.

The JAX package's oracle is compiled from its ``patchwork.cpp`` into this
module's own temporary directory (its loader builds next to the source
otherwise, and another test worker may be doing the same at the same
moment); the port's builds into ``build/native/``."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import vilgod_tpu.ground.native as native_mod
from vilgod_tpu.ground import segment_ground as jax_segment_ground
from vilgod_tpu.ground import init_ground_state as jax_init_state
from vilgod_tpu.ground.native import NativePatchwork
import vilgod_tpu_torch.ground.native as port_native
from vilgod_tpu_torch.data import SyntheticDataset
from vilgod_tpu_torch.ground import (GroundConfig, init_ground_state,
                                     segment_ground, segment_sequence)
from vilgod_tpu_torch.tools import ground_oracle

from test_ground import make_scene, pad


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The native library built into a private directory; restored after."""
    so = tmp_path_factory.mktemp("native") / "_patchwork_native.so"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                    str(native_mod._SRC), "-o", str(so)], check=True,
                   capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_mod, "_SO", so)
        mp.setattr(native_mod, "_lib", None)
        yield NativePatchwork


def _port(pts, mask, state, cfg):
    g, state, aux = segment_ground(torch.from_numpy(pts),
                                   torch.from_numpy(mask), state, cfg)
    return g.numpy(), state, aux


def test_port_matches_native_oracle(oracle):
    """Fresh state both sides, tests/test_ground_native.py's scene and
    bound: ground IoU > 0.97."""
    rng = np.random.default_rng(666)
    cfg = GroundConfig(patch_capacity=512)
    pts, labels = make_scene(rng)
    g_native = oracle(cfg).segment(pts)
    padded, mask, _ = pad(pts, labels, 16384)
    g_port, _, _ = _port(padded, mask, init_ground_state(cfg), cfg)
    g_port = g_port[: len(pts)]
    iou = (g_native & g_port).sum() / max((g_native | g_port).sum(), 1)
    assert iou > 0.97, iou
    assert (g_port & labels).sum() / labels.sum() > 0.9


def test_port_tracks_native_oracle_over_a_sequence(oracle):
    """The A-GLE/TGR state threaded through the port's ``segment_ground``
    tracks the C++ singleton frame by frame (agreement > 0.999, as
    tests/test_ground_native.py holds the JAX package), and its adapted
    sensor height the oracle's."""
    ds = SyntheticDataset(n_sequences=1, seed=7, n_frames=6, n_ground=8000,
                          n_vehicles=3, n_pedestrians=1, n_moving=1,
                          area=50.0)
    seq = ds.sequence("synth_0")
    cfg = GroundConfig(patch_capacity=512, min_range=1.5)
    nat = oracle(cfg)
    state = init_ground_state(cfg)
    total = 32768
    for f in range(6):
        pts = seq.get_lidar_points(f).astype(np.float32)
        pts[:, 2] -= 1.723
        g_nat = nat.segment(pts)
        pp = np.zeros((total, 5), np.float32)
        pp[: len(pts)] = pts
        mm = np.zeros(total, bool)
        mm[: len(pts)] = True
        g, state, _ = _port(pp, mm, state, cfg)
        agree = (g[: len(pts)] == g_nat).mean()
        assert agree > 0.999, f"frame {f}: agreement {agree:.4f}"
    assert float(state.sensor_height) == pytest.approx(nat.sensor_height,
                                                       abs=1e-3)


def test_segment_ground_matches_jax_and_segment_sequence():
    """Three frames of a drifting scene: masks, the state and the aux
    integers equal JAX's ``segment_ground`` step by step, normals and
    means within 1e-5 (float64 patch sums in the port); the port's
    ``segment_sequence`` gives the same masks and final state."""
    rng = np.random.default_rng(5)
    cfg = GroundConfig(patch_capacity=256)
    frames, masks = [], []
    for f in range(3):
        pts, labels = make_scene(rng, n_ground=6000)
        padded, mask, _ = pad(pts, labels, 8192)
        frames.append(padded)
        masks.append(mask)
    state_t, state_j = init_ground_state(cfg), jax_init_state(cfg)
    per_frame = []
    for pts, mask in zip(frames, masks):
        g_t, state_t, aux_t = _port(pts, mask, state_t, cfg)
        g_j, state_j, aux_j = jax_segment_ground(
            jnp.asarray(pts), jnp.asarray(mask), state_j, cfg)
        np.testing.assert_array_equal(g_t, np.asarray(g_j))
        assert g_t.dtype == bool and g_t.sum() > 1000
        assert set(aux_t) == set(aux_j)
        for key in ("patch_ground", "n_ground", "noise"):
            np.testing.assert_array_equal(aux_t[key].numpy(),
                                          np.asarray(aux_j[key]), err_msg=key)
        for key in ("normals", "means"):
            np.testing.assert_allclose(aux_t[key].numpy(),
                                       np.asarray(aux_j[key]), atol=1e-5,
                                       err_msg=key)
        for key in ("elev_cnt", "elev_ptr", "flat_cnt", "flat_ptr"):
            np.testing.assert_array_equal(getattr(state_t, key).numpy(),
                                          np.asarray(getattr(state_j, key)))
        np.testing.assert_allclose(state_t.elevation_thr.numpy(),
                                   np.asarray(state_j.elevation_thr),
                                   atol=1e-5)
        per_frame.append(g_t)
    g_seq, state_seq = segment_sequence(torch.from_numpy(np.stack(frames)),
                                        torch.from_numpy(np.stack(masks)),
                                        cfg)
    np.testing.assert_array_equal(g_seq.numpy(), np.stack(per_frame))
    for a, b in zip(state_seq, state_t):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# the port's own oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cases():
    """tests/test_ground_native.py's four cases with the port's oracle and
    the port's ``segment_ground`` on the CPU."""
    return ground_oracle.run("cpu")


def test_port_oracle_flat_scene(cases):
    assert cases["recall"] > 0.9, cases
    assert cases["false_positive"] < 0.15, cases


def test_port_oracle_against_segment_ground(cases):
    assert cases["iou"] > 0.97, cases


def test_port_oracle_adapts_sensor_height(cases):
    assert abs(cases["sensor_height"] - 1.723) < 0.2, cases


def test_port_oracle_sequence_against_segment_ground(cases):
    assert len(cases["agreement"]) == 6
    assert min(cases["agreement"]) > 0.999, cases


def test_port_oracle_equals_jax_oracle(oracle):
    """The same code and flags: equal masks on every frame of the four
    cases' scenes, and the same sensor height after the 6-frame
    sequence."""
    rng = np.random.default_rng(666)
    cfg = GroundConfig(patch_capacity=512)
    port, jax_native = port_native.NativePatchwork(cfg), oracle(cfg)
    for _ in range(4):
        pts, _ = ground_oracle.flat_scene(rng)
        np.testing.assert_array_equal(port.segment(pts),
                                      jax_native.segment(pts))
    assert port.sensor_height == jax_native.sensor_height
    seq_cfg = GroundConfig(patch_capacity=512, min_range=1.5)
    port, jax_native = port_native.NativePatchwork(seq_cfg), oracle(seq_cfg)
    for pts in ground_oracle.sequence_frames():
        g = port.segment(pts)
        assert g.dtype == bool and g.sum() > 1000
        np.testing.assert_array_equal(g, jax_native.segment(pts))
    assert port.sensor_height == jax_native.sensor_height


def test_port_oracle_builds_under_build_native_only():
    """The library is named by the source's and flags' hash and lives in
    the checkout's ``build/native/``, not beside the source; the package
    exports the JAX package's two names."""
    path = port_native.library_path()
    assert path.parent == Path(port_native.__file__).resolve(
    ).parents[3] / "build" / "native"
    assert path.name.startswith("libpatchwork_") and path.suffix == ".so"
    port_native.load_library()
    assert path.exists()
    assert not list(Path(port_native.SOURCE).parent.glob("*.so"))
    assert set(port_native.__all__) == {"NativePatchwork", "load_library"}
    # the C side reads 4 floats a point: fewer columns never reach it
    with pytest.raises(ValueError, match="must be"):
        port_native.NativePatchwork().segment(np.zeros((10, 3), np.float32))
    assert port_native.NativePatchwork.__module__.startswith(
        "vilgod_tpu_torch.")


_RACE = """
import sys
from pathlib import Path
import numpy as np
import vilgod_tpu_torch.ground.native as native
from vilgod_tpu_torch.tools.ground_oracle import flat_scene
native.BUILD_DIR = Path(sys.argv[1])
g = native.NativePatchwork().segment(
    flat_scene(np.random.default_rng(1))[0])
print(int(g.sum()))
"""


def test_two_processes_build_the_oracle_at_once(tmp_path):
    """Two processes that find ``build/native/`` empty both build, and both
    load a whole library and segment: each build goes to its own
    temporary file and is renamed into place."""
    build = tmp_path / "build" / "native"
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(build)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0] and int(outs[0][0]) > 1000
    assert [f.name for f in build.iterdir()] == [
        port_native.library_path().name]
