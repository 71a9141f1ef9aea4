"""The port's multi-device layer (vilgod_tpu_torch/parallel and the stages'
mesh branches) against the JAX package's on the CPU.

JAX runs its sharded functions on conftest's 8 virtual CPU devices. The
port's mesh holds D logical shards of the CPU device (a device may repeat
in a ``Mesh``), and the stages see D devices through a monkeypatched
``parallel.local_devices``, the one place they learn their devices. Inputs
are JAX's own from tests/test_parallel.py, made from seeds with numpy.

Tolerances: every sharded function of the port equals the port's
single-device counterpart bit for bit. Against JAX the port keeps the
tolerances of its single-device tests: entropy within 1e-6 (the counts
are exact; the log and the division may round differently,
test_torch_entropy.py), the filter metrics as test_torch_filter.py holds
them (its float64 plane refit and hull), cluster probabilities within
1e-6 (test_torch_cluster.py), everything else exact; the classifier's
scores within 1e-5, with JAX's rule for argmax flips on tied scores.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vilgod_tpu import parallel as JP
from vilgod_tpu.config.presets import waymo_config as jax_waymo_config
from vilgod_tpu.data import SyntheticDataset as JaxSyntheticDataset
from vilgod_tpu.ground.patchwork import GroundConfig as JaxGroundConfig
from vilgod_tpu.pipeline import stages_geometry as JG
from vilgod_tpu.pipeline.runner import ZeroShotDetector as JaxDetector
from vilgod_tpu_torch import parallel as TP
from vilgod_tpu_torch.config import waymo_config
from vilgod_tpu_torch.data import SyntheticDataset
from vilgod_tpu_torch.ground.patchwork import GroundConfig, segment_sequence
from vilgod_tpu_torch.ops.entropy import entropy_sequence
from vilgod_tpu_torch.pipeline import stages_classify as TC
from vilgod_tpu_torch.pipeline import stages_geometry as TG
from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(d):
    return TP.make_mesh(devices=[CPU] * d)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# mesh and layouts
# ---------------------------------------------------------------------------

def test_local_devices_on_a_faked_four_card_machine(monkeypatch):
    """Every visible card, the state's first; the CPU is one shard. No
    tensor is made (none could be, without a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert TP.local_devices(torch.device("cuda", 2)) == [cuda[2], cuda[0],
                                                         cuda[1], cuda[3]]
    assert TP.local_devices("cuda") == [cuda[1], cuda[0], cuda[2], cuda[3]]
    assert TP.local_devices(CPU) == [CPU]
    mesh = TP.make_mesh()
    assert mesh.devices == tuple(cuda) and mesh.shape["dp"] == 4
    assert TP.make_mesh(2).devices == tuple(cuda[:2])


def test_layouts_split_and_replicate():
    """``frame_sharding`` splits dim 0 into contiguous chunks as ``P("dp")``
    does; ``replicated`` gives one copy per distinct device, shared by the
    logical shards on it."""
    mesh = _mesh(4)
    x = torch.arange(24).reshape(8, 3)
    parts = TP.frame_sharding(mesh).put(x)
    assert [p.tolist() for p in parts] == [x[2 * i:2 * i + 2].tolist()
                                           for i in range(4)]
    copies = TP.replicated(mesh).put(x)
    assert all(c is copies[0] for c in copies)
    assert torch.equal(copies[0], x)
    with pytest.raises(ValueError, match="must divide over the mesh"):
        TP.frame_sharding(_mesh(3)).put(x)


# ---------------------------------------------------------------------------
# sharded functions against the port's single device and JAX's mesh
# ---------------------------------------------------------------------------

def _entropy_inputs(f_pad, f_real):
    """tests/test_parallel.py's clouds: 96 points a frame, 32 of them a
    persistent structure, on the 5 mm lattice; the padded tail masked."""
    rng = np.random.default_rng(666)
    frames = rng.normal(size=(f_pad, 96, 3)).astype(np.float32)
    frames[:, :32] = rng.normal(size=(1, 32, 3)).astype(np.float32)
    frames = (np.round(frames / 0.005) * 0.005).astype(np.float32)
    masks = np.ones((f_pad, 96), bool)
    masks[:, 90:] = False
    masks[f_real:] = False
    return frames, masks


@pytest.mark.parametrize("d,chunk,tail", [(8, 4, 0), (2, 16, 0), (8, 8, 3),
                                          (2, 32, 3)],
                         ids=["d8", "d2", "d8-pad-aware", "d2-pad-aware"])
def test_sharded_entropy_matches_single_device_and_jax(d, chunk, tail):
    f_pad = d * chunk
    f_real = f_pad - tail
    frames, masks = _entropy_inputs(f_pad, f_real)
    kw = dict(window=4, skip_frames=1, radius=0.5)
    got = TP.sharded_entropy(_mesh(d), _t(frames), _t(masks), f_real=f_real,
                             **kw).numpy()
    single = entropy_sequence(_t(frames), _t(masks),
                              _t(np.arange(f_pad) < f_real), **kw).numpy()
    np.testing.assert_array_equal(got, single)
    want = np.asarray(JP.sharded_entropy(
        JP.make_mesh(d), jnp.asarray(frames), jnp.asarray(masks),
        f_real=f_real, block_size=64, **kw))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got[f_real:] == 1.0).all()
    assert (got[:f_real][masks[:f_real]] < 1.0).any()


def _bad_calls(port):
    """Each sharded function with a shape its gate refuses: (name, call)."""
    P = TP if port else JP
    arr = _t if port else jnp.asarray
    mesh = _mesh(8) if port else JP.make_mesh(8)

    def entropy(f_total, f_real):
        return lambda: P.sharded_entropy(
            mesh, arr(np.zeros((f_total, 16, 3), np.float32)),
            arr(np.ones((f_total, 16), bool)), f_real=f_real, window=4)

    z = arr(np.zeros((12, 4), np.float32))
    return {
        "padded tail": entropy(64, 58),
        "frames per device": entropy(8, None),
        "chunk": lambda: P.sharded_cluster_chunk(mesh, None, (), (), 0, 666,
                                                 chunk=12),
        "ground": lambda: P.sharded_ground(mesh, z, z, None),
        "filter": lambda: P.sharded_filter_metrics(mesh, *([z] * 8), 666,
                                                   20.0),
    }


@pytest.mark.parametrize("case", ["padded tail", "frames per device",
                                  "chunk", "ground", "filter"])
def test_sharded_functions_raise_jax_errors(case):
    """The gates' ValueErrors, with JAX's messages word for word."""
    with pytest.raises(ValueError) as port_err:
        _bad_calls(True)[case]()
    with pytest.raises(ValueError) as jax_err:
        _bad_calls(False)[case]()
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("d", [8, 2])
def test_global_detection_count(d):
    det_valid = np.arange(8 * 6).reshape(8, 6) % 3 == 0
    total = TP.global_detection_count(_mesh(d), _t(det_valid))
    assert int(total) == int(det_valid.sum())
    assert int(total) == int(JP.global_detection_count(JP.make_mesh(d),
                                                       jnp.asarray(det_valid)))


@pytest.fixture(scope="module")
def ground_scene():
    """tests/test_parallel.py's sharded-ground scene: 16 frames of 2048
    points, seed 9."""
    seq = JaxSyntheticDataset(n_sequences=1, n_frames=16, seed=9,
                              n_ground=1200, n_vehicles=1,
                              n_moving=0).sequence("synth_0")
    pts = np.zeros((16, 2048, 4), np.float32)
    msk = np.zeros((16, 2048), bool)
    for f in range(16):
        p = seq.get_lidar_points(f)[:2048]
        pts[f, :len(p), :p.shape[1]] = p[:, :4]
        msk[f, :len(p)] = True
    return pts, msk


@pytest.mark.parametrize("d", [8, 2])
def test_sharded_ground_equals_per_chunk_scans_and_jax(ground_scene, d):
    pts, msk = ground_scene
    chunk = 16 // d
    got = TP.sharded_ground(_mesh(d), _t(pts), _t(msk),
                            GroundConfig(patch_capacity=128),
                            z_offset=1.723).numpy()
    per_chunk = np.concatenate([
        segment_sequence(_t(pts[c * chunk:(c + 1) * chunk]),
                         _t(msk[c * chunk:(c + 1) * chunk]),
                         GroundConfig(patch_capacity=128), 1.723)[0].numpy()
        for c in range(d)])
    np.testing.assert_array_equal(got, per_chunk)
    want = np.asarray(JP.sharded_ground(
        JP.make_mesh(d), jnp.asarray(pts), jnp.asarray(msk),
        JaxGroundConfig(patch_capacity=128), z_offset=1.723))
    np.testing.assert_array_equal(got, want)
    assert got.any()


@pytest.fixture(scope="module")
def filter_inputs():
    """tests/test_parallel.py's filter inputs (8 frames, 16 clusters), the
    last frame a padded one (every mask off), as a padded bucket's tail."""
    rng = np.random.default_rng(666)
    f_pad, n_pts, n_ng, c = 8, 4096, 2048, 16
    pts = rng.uniform(-30, 30, (f_pad, n_pts, 3)).astype(np.float32)
    pts[..., 2] = rng.normal(-1.7, 0.2, (f_pad, n_pts))
    pm = np.ones((f_pad, n_pts), bool)
    pm[:, 3500:] = False
    gm = pts[..., 2] < -1.5
    tr = np.tile(np.eye(4, dtype=np.float32), (f_pad, 1, 1))
    nx = rng.uniform(-30, 30, (f_pad, n_ng, 3)).astype(np.float32)
    ne = rng.uniform(0, 1, (f_pad, n_ng)).astype(np.float32)
    lb = rng.integers(-1, c, (f_pad, n_ng)).astype(np.int32)
    nm = np.ones((f_pad, n_ng), bool)
    nm[:, 1800:] = False
    pm[-1] = gm[-1] = nm[-1] = False
    return pts, pm, gm, tr, nx, ne, lb, nm


@pytest.mark.parametrize("d", [8, 2])
def test_sharded_filter_metrics_matches_single_device_and_jax(filter_inputs,
                                                              d):
    """Every field equals the port's ``filter_metrics_all`` bit for bit
    (the same per-frame code, each frame keyed by its global index);
    against JAX's sharded metrics as test_torch_filter.py holds the
    single-device ones."""
    kw = dict(ransac_iters=25, max_clusters=16)
    args = tuple(_t(a) for a in filter_inputs)
    got = TP.sharded_filter_metrics(_mesh(d), *args, 666, 20.0, **kw)
    single = TG.filter_metrics_all(*args, 666, 20.0, **kw)
    assert set(got) == set(single)
    for k in single:
        np.testing.assert_array_equal(got[k].numpy(), single[k].numpy(),
                                      err_msg=k)
    want = JP.sharded_filter_metrics(
        JP.make_mesh(d), *map(jnp.asarray, filter_inputs), 666, 20.0, **kw)
    real = slice(0, 7)  # the padded frame's plane is RANSAC over nothing
    for k in ("height", "size"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("plane", "dmin", "dmax", "ephe_p"):
        np.testing.assert_allclose(got[k].numpy()[real],
                                   np.asarray(want[k])[real], atol=1e-5,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(got["hull_area"].numpy(),
                               np.asarray(want["hull_area"]), rtol=1e-3,
                               atol=1e-6)


def _blob_inputs():
    """tests/test_parallel.py's clustering inputs: 8 frames of two dense
    blobs in clutter, 512 non-ground points."""
    rng = np.random.default_rng(666)
    f_pad, n_ng = 8, 512
    xyz = rng.normal(scale=4.0, size=(f_pad, n_ng, 3)).astype(np.float32)
    xyz[:, :96] = rng.normal(scale=0.15, size=(1, 96, 3)).astype(np.float32)
    xyz[:, 96:192] = 5.0 + rng.normal(scale=0.15,
                                      size=(1, 96, 3)).astype(np.float32)
    m = np.ones((f_pad, n_ng), bool)
    m[:, 500:] = False
    ent = rng.uniform(size=(f_pad, n_ng)).astype(np.float32)
    kw = dict(chunk=f_pad, n_frames_window=2, cap_in=1024, eps=0.4,
              min_samples=3, min_cluster_size=5, max_clusters=16,
              capacity=256)
    return (xyz, m, ent, np.ones(f_pad, bool)), kw


def _paged_inputs():
    """tests/test_torch_cluster.py's paged scene: 4 frames of three blobs
    plus clutter in 8192 points, a 16384-point cluster input (paged)."""
    rng = np.random.default_rng(25)
    xyz = np.zeros((4, 8192, 3), np.float32)
    m = np.zeros((4, 8192), bool)
    for f in range(4):
        pts = [c + rng.normal(0, 0.05, (500, 3))
               for c in ((0, 0, 1), (4, 1, 1), (-3, 5, 1))]
        pts = np.concatenate(pts + [rng.uniform(-8, 8, (400, 3))])
        xyz[f, :len(pts)] = np.round(pts / 0.005) * 0.005
        m[f, :len(pts)] = True
    ent = rng.uniform(0, 1, (4, 8192)).astype(np.float32)
    kw = dict(chunk=4, cap_in=16384, max_clusters=32, capacity=512)
    return (xyz, m, ent, np.ones(4, bool)), kw


NAMES = ("labels", "probs", "det_n", "det_center", "det_static", "table")


@pytest.mark.parametrize("inputs,d", [(_blob_inputs, 8), (_blob_inputs, 2),
                                      (_paged_inputs, 2)],
                         ids=["per-frame-d8", "per-frame-d2", "paged-d2"])
def test_sharded_cluster_chunk_matches_single_device_and_jax(inputs, d):
    """Bit-equal to the single-device chunk (pages are distance- and
    cell-isolated); JAX's sharded chunk on the per-frame scene."""
    arrays, kw = inputs()
    dev_args = (*(_t(a) for a in arrays[:3]), int(arrays[3].sum()))
    stats = TG.frame_select_stats_all(*dev_args)
    single = TG.cluster_frames_chunk(*dev_args, stats, 0, 666, **kw)
    got = TP.sharded_cluster_chunk(_mesh(d), TG.cluster_frames_chunk,
                                   dev_args, stats, 0, 666, **kw)
    assert int(single[0].max()) >= 0, "scene produced no clusters"
    for a, b, name in zip(got, single, NAMES):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    if kw["cap_in"] >= 16384:
        return  # the JAX paged chunk: tests/test_torch_cluster.py
    j_args = tuple(jnp.asarray(a) for a in arrays)
    want = JP.sharded_cluster_chunk(
        JP.make_mesh(d), JG.cluster_frames_chunk, j_args,
        JG.frame_select_stats_all(*j_args), 0, 666, **kw)
    for a, b, name in zip(got, want, NAMES):
        if name == "probs":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


# ---------------------------------------------------------------------------
# the sharded classifier
# ---------------------------------------------------------------------------

# tests/test_parallel.py's tower with the tokenizer's whole vocabulary: JAX
# clamps its 1024-row embedding gather at the start token (49406), torch
# raises
TINY = dict(image_size=32, patch_size=16, vision_width=64, vision_layers=2,
            vision_heads=2, embed_dim=32, context_length=77,
            vocab_size=49408, text_width=64, text_heads=2, text_layers=2)
CLIP_CFG = {"class_list": ["car", "person"],
            "class_mapping": {"car": "Vehicle", "person": "Pedestrian"}}


def test_sharded_classifier_matches_single_device_and_jax():
    """tests/test_parallel.py's tiny tower, carried across from JAX: the
    batch split over 8 logical shards against the whole batch and against
    JAX's classifier on its 8-device mesh."""
    from vilgod_tpu.models.clip import CLIPConfig as JaxCLIPConfig
    from vilgod_tpu.models.clip_wrapper import ClipWrapper as JaxClipWrapper
    from vilgod_tpu_torch.models.clip import CLIPConfig, params_from_jax
    from vilgod_tpu_torch.models.clip_wrapper import ClipWrapper

    rng = np.random.default_rng(666)
    jw = JaxClipWrapper(CLIP_CFG, model_cfg=JaxCLIPConfig(**TINY))
    tcfg = CLIPConfig(**TINY)
    tw = ClipWrapper(CLIP_CFG, model_cfg=tcfg, device="cpu",
                     model=params_from_jax(jax.tree.map(np.asarray,
                                                        jw.params), tcfg,
                                           device="cpu"))
    f_pad, n_ng, n_clusters, cap = 8, 256, 4, 64
    make_kw = dict(num_clusters=n_clusters, capacity=cap, resolution=16,
                   depth=4, image_size=32)
    ng_xyz = rng.normal(scale=3.0, size=(f_pad, n_ng, 3)).astype(np.float32)
    tables = rng.integers(0, n_ng, size=(f_pad, n_clusters, cap)).astype(
        np.int32)
    table_masks = rng.uniform(size=(f_pad, n_clusters, cap)) < 0.8
    b = 16
    fids = rng.integers(0, f_pad, size=b).astype(np.int32)
    cids = rng.integers(0, n_clusters, size=b).astype(np.int32)
    trs = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    trs[:, :3, 3] = rng.normal(scale=1.0, size=(b, 3))

    bufs = (_t(ng_xyz), _t(tables), _t(table_masks))
    idx1, sc1 = (x.numpy() for x in tw.make_cluster_classifier(**make_kw)(
        *bufs, fids, cids, trs))
    run = TC.mesh_classifier(tw, _mesh(8), *bufs, **make_kw)
    idx2, sc2 = (x.numpy() for x in run(fids, cids, trs))
    jclassify = jw.make_cluster_classifier(n_clusters, cap, resolution=16,
                                           depth=4, image_size=32)
    mesh = JP.make_mesh()
    repl, bsh = JP.replicated(mesh), JP.frame_sharding(mesh)
    idx3, sc3 = (np.asarray(x) for x in jclassify(
        *(jax.device_put(jnp.asarray(a), repl)
          for a in (ng_xyz, tables, table_masks)),
        *(jax.device_put(a, bsh) for a in (fids, cids, trs))))
    assert idx2.shape == (b, 4) and sc2.shape == (b, 4)
    for idx, sc in ((idx1, sc1), (idx3, sc3)):
        np.testing.assert_allclose(sc2, sc, atol=1e-5, rtol=1e-5)
        # near-tied view logits may flip the argmax when the batch splits;
        # an index may differ only where the winning scores tie
        assert np.all((idx2 == idx) | (np.abs(sc2 - sc) <= 2e-5))


def test_clip_replica_is_an_independent_copy():
    """A replica holds a copy of the weights (not the same tensors), the
    same prompts, and classifies as the original does."""
    from vilgod_tpu_torch.models.clip import CLIPConfig
    from vilgod_tpu_torch.models.clip_wrapper import ClipWrapper

    tw = ClipWrapper(CLIP_CFG, model_cfg=CLIPConfig(**TINY), device="cpu")
    rep = tw.replica("cpu")
    assert rep.model is not tw.model and rep.class_list == tw.class_list
    for a, b in zip(rep.model.parameters(), tw.model.parameters()):
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    torch.testing.assert_close(rep.text_features, tw.text_features,
                               rtol=0, atol=0)
    images = np.random.default_rng(0).uniform(size=(3, 32, 32))
    for a, b in zip(rep.predict(images), tw.predict(images)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the stages: mesh branches under JAX's gates
# ---------------------------------------------------------------------------

CAP = {"max_points": 16384, "max_ng_points": 8192, "max_clusters": 64,
       "max_cluster_points": 2048, "max_tracks": 64,
       "max_cluster_input": 8192, "clip_batch": 8}
GEOMETRY = ["mask_ground_points", "calculate_entropy_scores",
            "spatial_clustering", "filter_detections"]
STAGE_SCENE = dict(n_sequences=1, n_frames=16, seed=3, n_ground=2500,
                   n_vehicles=2, n_pedestrians=1, n_moving=1)
SHARDED = ("sharded_ground", "sharded_entropy", "sharded_cluster_chunk",
           "sharded_filter_metrics")


def _window4(cfg):
    for p in cfg["pipeline"]:
        if p["name"] == "calculate_entropy_scores":
            p.setdefault("args", {})["n_neighbouring_frames"] = 4
    return cfg


def _fake_devices(monkeypatch, d):
    monkeypatch.setattr(TP, "local_devices", lambda dev: [dev] * d)


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def run(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)
    monkeypatch.setattr(module, name, run)


@pytest.fixture(scope="module")
def stage_runs():
    """Stages 1-4 on a 16-frame scene (window 4, ``shard_ground`` off: its
    contract is per-chunk equality, held above) with two logical shards,
    and on one device; the sharded functions each run are recorded."""
    states, calls = {}, []
    for d in (2, 1):
        with pytest.MonkeyPatch.context() as mp:
            _fake_devices(mp, d)
            for name in SHARDED:
                _spy(mp, TP, name, calls)
            cfg = _window4(waymo_config(capacity=CAP,
                                        pipeline_active=GEOMETRY,
                                        parallel={"shard_ground": False}))
            zsd = ZeroShotDetector(SyntheticDataset(**STAGE_SCENE).sequence(
                "synth_0"), "synth_0", cfg, device="cpu")
            zsd.process()
            states[d] = zsd.state
    return states, calls


def test_stages_sharded_over_two_devices_equal_single_device(stage_runs):
    states, calls = stage_runs
    assert calls == ["sharded_entropy", "sharded_cluster_chunk",
                     "sharded_filter_metrics"]
    sharded, single = states[2], states[1]
    for name in ("ground_mask", "ng_entropy", "labels", "probs", "det_valid",
                 "det_center", "det_n", "plane_ref"):
        np.testing.assert_array_equal(getattr(sharded, name),
                                      getattr(single, name), err_msg=name)
    assert single.det_valid.sum(axis=1).min() >= 3  # the scene's objects


class _Taken(Exception):
    pass


def _stop(monkeypatch, module, name):
    def run(*args, **kw):
        raise _Taken(name)
    monkeypatch.setattr(module, name, run)


GATES = [
    # (stage, shards, the path it takes); 16 frames, window 4, chunk 16
    ("mask_ground_points", 2, "sharded_ground"),
    ("mask_ground_points", 4, "segment_sequence"),   # 4 frames a shard < 8
    ("mask_ground_points", 3, "segment_sequence"),   # 3 does not divide 16
    ("calculate_entropy_scores", 2, "sharded_entropy"),
    ("calculate_entropy_scores", 8, "entropy_sequence"),  # 2 < window 4
    ("calculate_entropy_scores", 3, "entropy_sequence"),
    ("spatial_clustering", 2, "sharded_cluster_chunk"),
    ("spatial_clustering", 3, "cluster_frames_chunk"),
    ("spatial_clustering", 32, "cluster_frames_chunk"),  # 32 > chunk 16
    ("filter_detections", 2, "sharded_filter_metrics"),
    ("filter_detections", 3, "filter_metrics_all"),
]


@pytest.mark.parametrize("stage,d,path", GATES,
                         ids=[f"{s}-{d}" for s, d, _ in GATES])
def test_stage_gates(stage_runs, monkeypatch, stage, d, path):
    """Each stage takes its mesh branch exactly where JAX's gate passes
    (D divides the frames or the chunk; at least 8 frames a shard for the
    ground, the window for the entropy), else its single-device path; a
    ``parallel`` switch off takes the single-device path too."""
    state = stage_runs[0][1]
    _fake_devices(monkeypatch, d)
    for module, name in ((TP, "sharded_ground"), (TP, "sharded_entropy"),
                         (TP, "sharded_cluster_chunk"),
                         (TP, "sharded_filter_metrics"),
                         (TG, "segment_sequence"), (TG, "entropy_sequence"),
                         (TG, "cluster_frames_chunk"),
                         (TG, "filter_metrics_all")):
        _stop(monkeypatch, module, name)
    # the clustering's selection statistics come before its gate
    monkeypatch.setattr(TG, "frame_select_stats_all", lambda *a: (None,) * 3)
    monkeypatch.setitem(state.done, "mask_ground_points", False)
    switch = {"mask_ground_points": "shard_ground",
              "calculate_entropy_scores": "shard_frames",
              "spatial_clustering": "shard_cluster",
              "filter_detections": "shard_filter"}[stage]
    single = {"sharded_ground": "segment_sequence",
              "sharded_entropy": "entropy_sequence",
              "sharded_cluster_chunk": "cluster_frames_chunk",
              "sharded_filter_metrics": "filter_metrics_all"}.get(path, path)
    for par, want in (({}, path), ({switch: False}, single)):
        cfg = _window4(waymo_config(capacity=CAP, pipeline_active=GEOMETRY,
                                    parallel=par))
        args = next(p.get("args", {}) for p in cfg["pipeline"]
                    if p["name"] == stage)
        kw = {} if stage == "mask_ground_points" else {"force": True}
        with pytest.raises(_Taken) as taken:
            getattr(TG, stage)(state, cfg, **{**args, **kw})
        assert str(taken.value) == want


class _FakeClip:
    """Classifies item (f, c) as class (f + c) % 2 with score 0.5 + c / 100
    on every view, recording each call's batch size and device."""
    class_list = CLIP_CFG["class_list"]
    class_mapping = CLIP_CFG["class_mapping"]
    text_features = torch.zeros(2, 4)

    def __init__(self):
        self.calls = []

    def make_cluster_classifier(self, **_):
        def run(ng_xyz, tables, table_masks, fids, cids, trs):
            self.calls.append((len(fids), ng_xyz.device))
            f, c = (torch.as_tensor(np.asarray(x)) for x in (fids, cids))
            idx = ((f + c) % 2).to(torch.int32)[:, None].expand(-1, 4)
            score = (0.5 + c.float() / 100)[:, None].expand(-1, 4)
            return idx, score
        return run


@pytest.mark.parametrize("d,sizes", [(4, [8, 8, 8, 8]), (3, [35])],
                         ids=["sharded", "batch-does-not-divide"])
def test_classification_splits_batches_under_jax_tail_rule(
        stage_runs, monkeypatch, d, sizes):
    """A 140-item batch over 4 shards: the 30 detections run as one tail
    batch of 32 (JAX's tail rounded down to a multiple of the shards) in
    four shards of 8; over 3 shards (140 does not divide) one batch of 35
    on one device. The classes and scores are the same."""
    state = stage_runs[0][1]
    _fake_devices(monkeypatch, d)
    monkeypatch.setattr(state, "caps",
                        dataclasses.replace(state.caps, clip_batch=140))
    valid = np.zeros_like(state.det_valid)
    valid.flat[np.flatnonzero(state.det_valid)[:30]] = True
    for name, value in (("det_valid", valid),
                        ("det_cls", state.det_cls.copy()),
                        ("det_score", state.det_score.copy())):
        monkeypatch.setattr(state, name, value)
    clip = _FakeClip()
    TC.classification(state, waymo_config(capacity=CAP), clip_model=clip,
                      force=True)
    assert [n for n, _ in clip.calls] == sizes
    assert all(dev == CPU for _, dev in clip.calls)
    f, c = np.nonzero(valid)
    assert (state.det_score[f, c]
            == np.float32(0.5) + c.astype(np.float32) / np.float32(100)).all()
    names = [CLIP_CFG["class_mapping"][CLIP_CFG["class_list"][k]]
             for k in (f + c) % 2]
    assert [state.det_cls[i, j] for i, j in zip(f, c)] == [
        TC.MAPPED_CLASSES.index(n) for n in names]


@pytest.mark.slow
def test_full_geometry_pipeline_sharded_matches_jax_sharded():
    """tests/test_parallel.py's 32-frame full-geometry run: the port's
    stages 1-4 over 8 logical shards against JAX's on its 8-device mesh
    (window 4, ``shard_ground`` off), held as test_torch_slice.py holds
    the single-device stages."""
    cap = {**CAP, "max_cluster_points": 2048}
    scene = dict(STAGE_SCENE, n_frames=32)
    jcfg = jax_waymo_config(capacity=cap, pipeline_active=GEOMETRY,
                            parallel={"shard_frames": True,
                                      "shard_ground": False})
    jcfg["pipeline"] = [
        {**p, "args": {**p.get("args", {}), "n_neighbouring_frames": 4}}
        if p["name"] == "calculate_entropy_scores" else p
        for p in jcfg["pipeline"]]
    zj = JaxDetector(JaxSyntheticDataset(**scene).sequence("synth_0"),
                     "synth_0", jcfg)
    zj.process()
    j = zj.state
    with pytest.MonkeyPatch.context() as mp:
        _fake_devices(mp, 8)
        cfg = _window4(waymo_config(capacity=cap, pipeline_active=GEOMETRY,
                                    parallel={"shard_ground": False}))
        zt = ZeroShotDetector(SyntheticDataset(**scene).sequence("synth_0"),
                              "synth_0", cfg, device="cpu")
        zt.process()
    t = zt.state
    for name in ("ground_mask", "labels", "det_n", "det_static",
                 "det_valid"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    np.testing.assert_allclose(t.ng_entropy, j.ng_entropy, atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.probs, j.probs, atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.det_center, j.det_center, atol=1e-4, rtol=0)
