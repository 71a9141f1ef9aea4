"""The port's dataset adapters and pseudo-label export
(vilgod_tpu_torch/data/{openpcdet,waymo,argoverse,export}.py) against the
JAX package's on tests/test_datasets.py's fabricated OpenPCDet layouts.

Each package reads the same files into its own infos list (the
Argoverse adapter caches its adapted annos on the info dicts in place,
so one list is never shared between the packages). Points, poses,
filtered annos, moving flags and sequence slicing are equal; both
exports write equal infos and point files, and each package loads the
other's. The full 24-frame parity scene, exported and reloaded, gives
``SequenceState.set_frame`` the same quantised frames as the synthetic
source: the intensity survives the export's arctanh and the reader's
tanh within half a 5 mm step."""
import pickle

import numpy as np
import pytest
import torch

from vilgod_tpu import data as J
from vilgod_tpu.data import export as JX
from vilgod_tpu_torch import data as T
from vilgod_tpu_torch.data import export as TX

from test_datasets import argo_root, waymo_root  # noqa: F401  (fixtures)


def _assert_same(a, b, path="root"):
    """Deep equality of nested dicts / lists / arrays, dtypes included."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                            b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def _no_tensors(obj, path="root"):
    assert not isinstance(obj, torch.Tensor), path
    if isinstance(obj, dict):
        for k, v in obj.items():
            _no_tensors(v, f"{path}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _no_tensors(v, f"{path}[{i}]")
    elif isinstance(obj, np.ndarray):
        assert obj.dtype != object or all(
            not isinstance(v, torch.Tensor) for v in obj.ravel()), path


def _same_dataset(jds, tds):
    """Every sequence of two adapters reads the same."""
    assert jds.sequence_names() == tds.sequence_names()
    assert jds.class_names == tds.class_names
    for name in jds.sequence_names():
        js, ts = jds.sequence(name), tds.sequence(name)
        assert js.sequence_length == ts.sequence_length
        assert js.indices == ts.indices
        assert js._moving_track_ids == ts._moving_track_ids
        for f in range(js.sequence_length):
            _assert_same(js.get_lidar_points(f), ts.get_lidar_points(f))
            _assert_same(js.get_pose(f), ts.get_pose(f))
            _assert_same(js.get_annos(f), ts.get_annos(f))
        _assert_same(jds.gt_annos(name), tds.gt_annos(name))


@pytest.mark.parametrize("start,end", [(None, None), (1, 2), (0, 1), (1, None),
                                       (2, 1), (1, 1)])
def test_waymo_adapter_matches_jax(waymo_root, start, end):
    """Points (tanh of the stored intensity), poses, filtered annos, the
    moving tracks and the slice of sequences (an end at or before the
    start keeps every sequence from the start)."""
    kw = dict(split="val", start_sequence=start, end_sequence=end)
    jds = J.WaymoSequenceDataset(waymo_root, **kw)
    tds = T.WaymoSequenceDataset(waymo_root, **kw)
    _same_dataset(jds, tds)
    if (start, end) == (None, None):
        seq = tds.sequence(tds.sequence_names()[0])
        assert seq.get_annos(0)["moving"].tolist() == [True, False]


def test_waymo_adapter_nlz_filter_matches_jax(waymo_root):
    """With the NLZ flag honoured, only points flagged -1 stay."""
    name = "segment-aaa_with_camera_labels"
    path = waymo_root / "waymo_processed_data_v0_5_0" / name / "0001.npy"
    pts = np.load(path)
    pts[::3, 5] = 1.0
    np.save(path, pts)
    jds = J.WaymoSequenceDataset(waymo_root, disable_nlz_flag=False)
    tds = T.WaymoSequenceDataset(waymo_root, disable_nlz_flag=False)
    _same_dataset(jds, tds)
    assert len(tds.sequence(name).get_lidar_points(1)) == len(pts) - 17


def test_argoverse_adapter_matches_jax(argo_root):
    """Frames in uuid order, boxes from location / dimensions /
    rotation_y, AV2 names mapped; the in-place anno cache is idempotent
    and gives the same annos on a second read."""
    jds = J.ArgoverseSequenceDataset(argo_root, split="val")
    tds = T.ArgoverseSequenceDataset(argo_root, split="val")
    _same_dataset(jds, tds)
    _same_dataset(jds, tds)          # from the cached, adapted annos
    info = tds.infos[0]
    assert "gt_boxes_lidar" in info["annos"]
    assert tds.adapt_annos(info) is info["annos"]
    assert T.argoverse.CLASS_MAPPING == J.argoverse.CLASS_MAPPING


def test_argoverse_npy_points_and_lidar_path(argo_root):
    """``lidar_path`` (relative to the root) wins over the velodyne
    ``.bin``, and ``.npy`` files load too."""
    with open(argo_root / "argo2_infos_val.pkl", "rb") as f:
        infos = pickle.load(f)
    pts = np.random.default_rng(3).normal(size=(30, 5)).astype(np.float32)
    np.save(argo_root / "frame1.npy", pts)
    infos[2]["lidar_path"] = "frame1.npy"          # uuid log_x/1
    with open(argo_root / "argo2_infos_val.pkl", "wb") as f:
        pickle.dump(infos, f)
    jds = J.ArgoverseSequenceDataset(argo_root)
    tds = T.ArgoverseSequenceDataset(argo_root)
    _same_dataset(jds, tds)
    np.testing.assert_array_equal(tds.sequence("log_x").get_lidar_points(1),
                                  pts[:, :4])


def _frames(n=3, tensors=False):
    rng = np.random.default_rng(4)
    out = []
    for f in range(n):
        k = f + 1
        res = {"boxes_lidar": rng.normal(size=(k, 7)).astype(np.float32),
               "name": np.array(["Vehicle", "Pedestrian", "Cyclist"][:k]),
               "score": rng.random(k).astype(np.float32),
               "moving": rng.random(k) > 0.5}
        if tensors:
            res = {key: (torch.from_numpy(v) if key != "name" else v)
                   for key, v in res.items()}
        out.append(res)
    return out


def test_export_pseudo_labels_matches_jax(waymo_root, tmp_path):
    """Equal infos (source metadata kept, annos replaced); from a
    synthetic source a skeleton info; torch tensors in the results are
    written as numpy."""
    jds = J.WaymoSequenceDataset(waymo_root)
    tds = T.WaymoSequenceDataset(waymo_root)
    name = tds.sequence_names()[1]
    jp = JX.export_pseudo_labels(jds, {name: _frames()}, tmp_path / "j.pkl")
    tp = TX.export_pseudo_labels(tds, {name: _frames(tensors=True)},
                                 tmp_path / "t.pkl")
    with open(jp, "rb") as f:
        j_infos = pickle.load(f)
    with open(tp, "rb") as f:
        t_infos = pickle.load(f)
    _no_tensors(t_infos)
    _assert_same(j_infos, t_infos)
    assert t_infos[0]["frame_id"].startswith("segment-bbb")
    syn_j = J.SyntheticDataset(n_sequences=1, n_frames=2, seed=1, n_ground=50)
    syn_t = T.SyntheticDataset(n_sequences=1, n_frames=2, seed=1, n_ground=50)
    _assert_same(JX.make_pseudo_infos(syn_j, {"synth_0": _frames(2)}),
                 TX.make_pseudo_infos(syn_t, {"synth_0": _frames(2)}))


def _gt_results(seq, n):
    """A perfect pseudo-labeler: each frame's GT as detections, object
    index as track id."""
    results, tids = [], []
    for f in range(n):
        gt = seq.get_annos(f)
        results.append({"boxes_lidar": gt["gt_boxes_lidar"].astype(np.float32),
                        "name": gt["gt_names"],
                        "score": np.full(len(gt["gt_names"]), 0.9, np.float32),
                        "moving": gt["moving"]})
        tids.append(np.arange(len(gt["gt_names"])))
    return results, tids


def test_export_pseudo_dataset_interchangeable(tmp_path):
    """Both packages write the same infos and point files; each package's
    reader loads the other's export to the same frames."""
    kw = dict(n_sequences=1, n_frames=4, seed=2, n_ground=500, n_vehicles=2,
              n_pedestrians=1, n_moving=1)
    jds, tds = J.SyntheticDataset(**kw), T.SyntheticDataset(**kw)
    results, tids = _gt_results(tds.sequence("synth_0"), 4)
    jp = JX.export_pseudo_dataset(jds, {"synth_0": results}, tmp_path / "j",
                                  track_ids_by_sequence={"synth_0": tids})
    tp = TX.export_pseudo_dataset(tds, {"synth_0": results}, tmp_path / "t",
                                  track_ids_by_sequence={"synth_0": tids})
    assert jp.name == tp.name == "waymo_processed_data_v0_5_0_infos_pseudo.pkl"
    with open(jp, "rb") as f:
        j_infos = pickle.load(f)
    with open(tp, "rb") as f:
        t_infos = pickle.load(f)
    _no_tensors(t_infos)
    _assert_same(j_infos, t_infos)
    for f in range(4):
        rel = f"waymo_processed_data_v0_5_0/synth_0/{f:04d}.npy"
        _assert_same(np.load(tmp_path / "j" / rel), np.load(tmp_path / "t" / rel))
    # each package reads the other's export
    _same_dataset(J.WaymoSequenceDataset(tmp_path / "t", split="pseudo"),
                  T.WaymoSequenceDataset(tmp_path / "j", split="pseudo"))
    lseq = T.WaymoSequenceDataset(tmp_path / "j", split="pseudo").sequence("synth_0")
    assert lseq.get_annos(1)["moving"].any()


def test_export_without_track_ids_matches_jax(tmp_path):
    kw = dict(n_sequences=1, n_frames=2, seed=3, n_ground=200)
    jds, tds = J.SyntheticDataset(**kw), T.SyntheticDataset(**kw)
    results, _ = _gt_results(tds.sequence("synth_0"), 2)
    jp = JX.export_pseudo_dataset(jds, {"synth_0": results}, tmp_path / "j",
                                  split="train", processed_tag="tag")
    tp = TX.export_pseudo_dataset(tds, {"synth_0": results}, tmp_path / "t",
                                  split="train", processed_tag="tag")
    with open(jp, "rb") as f:
        j_infos = pickle.load(f)
    with open(tp, "rb") as f:
        t_infos = pickle.load(f)
    _assert_same(j_infos, t_infos)
    assert t_infos[1]["annos"]["obj_ids"][0] == "synth_0_1_0"


def test_parity_scene_round_trip_quantises_equal(tmp_path):
    """The 24-frame parity scene of chip_smoke.py, exported to the Waymo
    layout and read back: ``set_frame``'s 5 mm quantisation of every
    frame (x, y, z and the intensity, stored as arctanh and read through
    tanh) equals the synthetic source's, and the poses are equal."""
    from vilgod_tpu_torch.pipeline.state import Capacity, SequenceState
    from vilgod_tpu_torch.tools.scenes import CAPS, SCENE

    ds = T.SyntheticDataset(**SCENE)
    seq = ds.sequence("synth_0")
    n = SCENE["n_frames"]
    results, tids = _gt_results(seq, n)
    TX.export_pseudo_dataset(ds, {"synth_0": results}, tmp_path,
                             track_ids_by_sequence={"synth_0": tids})
    lseq = T.WaymoSequenceDataset(tmp_path, split="pseudo").sequence("synth_0")
    assert lseq.sequence_length == n
    caps = Capacity.from_cfg({"capacity": CAPS})
    a = SequenceState.allocate("synth_0", n, caps, device="cpu")
    b = SequenceState.allocate("synth_0", n, caps, device="cpu")
    for f in range(n):
        a.set_frame(f, seq.get_lidar_points(f), seq.get_pose(f))
        b.set_frame(f, lseq.get_lidar_points(f), lseq.get_pose(f))
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.points_mask, b.points_mask)
    np.testing.assert_array_equal(a.poses, b.poses)
    assert (b.points[..., 3][b.points_mask] == 100).all()
