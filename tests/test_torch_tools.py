"""The port's run tool (``vilgod_tpu_torch.tools.run``), its re-scoring
CLI (``vilgod_tpu_torch.tools.evaluate``), its ``utils/common`` helpers,
and the runner's ``profile_dir`` trace.

The helpers are held against the JAX package's own (``vilgod_tpu.utils``)
on tests/test_tools.py's oracles and on random inputs; ``parse_overrides``
against the JAX tool's on tests/test_tools.py's cases; the tool runs the
geometry stages on the CPU on tests/test_pipeline_e2e.py's smoke scene,
writes ``ap_results.json`` and, with ``profile_dir``, a trace with one span
per active stage. The same scene exported to the Waymo layout and run
from disk (``preprocessor=waymo paths.data=...``) gives the same
pipeline outputs; the port's evaluate CLI and the JAX package's print the
same APs on the port's results and on JAX-schema result files."""
import importlib.util
import json
import logging
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from vilgod_tpu import utils as J
from vilgod_tpu_torch import utils as T
from vilgod_tpu_torch.tools import run as R

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_run_tool():
    return _jax_tool("run")


def test_common_utils_oracles():
    """tests/test_tools.py's oracles, on the port's helpers."""
    m = np.zeros((4, 5))
    m[0, 0] = m[2, 0] = m[2, 3] = 1     # connected via column 0 / row 2
    m[3, 4] = 1                          # isolated
    assert sorted(len(g) for g in T.extract_groups(m)) == [1, 3]
    assert T.angle_between_vectors([1, 0], [0, 1]) == pytest.approx(90,
                                                                    abs=0.5)
    assert T.angle_between_vectors([1, 0], [1, 0]) == pytest.approx(0,
                                                                    abs=1.0)
    boxes = np.array([[0, 0, 0, 4, 2, 1.5, 0.0],
                      [4, 0, 0, 4, 2, 1.5, np.pi / 2]])
    out = T.interpolate_bounding_boxes(boxes, [0, 4], 5)
    assert out.shape == (5, 7)
    np.testing.assert_allclose(out[2, 0], 2.0)
    assert out[2, 6] == pytest.approx(np.pi / 4, abs=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_common_utils_match_jax_package(seed):
    rng = np.random.default_rng(seed)
    m = (rng.uniform(size=(9, 11)) < 0.15).astype(np.float32)
    assert T.extract_groups(m) == J.extract_groups(m)
    v1, v2 = rng.normal(size=3), rng.normal(size=3)
    assert T.angle_between_vectors(v1, v2) == J.angle_between_vectors(v1, v2)
    assert T.angle_between_vectors(v1, -v1) == J.angle_between_vectors(v1, -v1)
    boxes = rng.normal(size=(4, 7))
    idx = np.sort(rng.choice(12, 4, replace=False))
    np.testing.assert_array_equal(T.interpolate_bounding_boxes(boxes, idx, 12),
                                  J.interpolate_bounding_boxes(boxes, idx, 12))
    xss = [list(range(k)) for k in rng.integers(0, 4, 5)]
    assert T.flatten(xss) == J.flatten(xss)
    for number, postfix, zeros in ((7, ".pkl", 4), (12345, ".npz", 6)):
        assert (T.build_number_file_path("d", number, postfix, zeros)
                == J.build_number_file_path("d", number, postfix, zeros))


def test_seed_logger_and_dirs(tmp_path, caplog):
    """``set_random_seed`` seeds random, numpy and torch;
    ``check_and_create_dir`` says whether it created the directory;
    ``create_logger`` adds one handler however often it is called."""
    draws = []
    for _ in range(2):
        T.set_random_seed(5)
        draws.append((random.random(), np.random.rand(), float(torch.rand(1))))
    assert draws[0] == draws[1]
    d = tmp_path / "a" / "b"
    assert T.check_and_create_dir(d) and d.is_dir()
    assert not T.check_and_create_dir(d)
    logger = T.create_logger("vilgod_tpu_torch.test_tools")
    assert T.create_logger("vilgod_tpu_torch.test_tools") is logger
    assert len(logger.handlers) == 1 and logger.level == logging.INFO
    with caplog.at_level(logging.INFO, logger=logger.name):
        T.print_separator(logger, "=", 10)
    assert [r.getMessage() for r in caplog.records] == ["=" * 10, ""]


@pytest.mark.parametrize("argv,want", [
    (["a.b=3", "c=[1,2]", "d.e=text", "f=true"],
     {"a": {"b": 3}, "c": [1, 2], "d": {"e": "text"}, "f": True}),
    (["x=None", "y=FALSE", "z.w=1.5", "p=a=b"],
     {"x": None, "y": False, "z": {"w": 1.5}, "p": "a=b"}),
], ids=["test_tools-cases", "literals"])
def test_parse_overrides_matches_jax_tool(argv, want):
    assert R.parse_overrides(argv) == want
    assert R.parse_overrides(argv) == _jax_run_tool().parse_overrides(argv)


def test_parse_overrides_rejects_bare_words():
    with pytest.raises(SystemExit):
        R.parse_overrides(["nokey"])


@pytest.mark.parametrize("preset", ["waymo", "argoverse"])
def test_real_datasets_raise(preset, tmp_path):
    """A real-data preprocessor without ``paths.data`` raises, naming
    ``paths.data``, and never falls back to the synthetic scene (the JAX
    tool does; a standing difference, ROADMAP queue 3)."""
    with pytest.raises(ValueError, match="needs paths.data"):
        R.main([f"preprocessor={preset}", "device=cpu",
                f"paths.results={tmp_path / 'results'}"])
    assert not (tmp_path / "results").exists()


def test_default_device_is_the_card():
    """Without ``device=`` the tool runs on ``cuda``; without a card it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert T.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        R.main(["preprocessor=synthetic"])


def test_clip_model_from_config(monkeypatch, tmp_path, caplog):
    """With ``classification`` active the tool builds a ``ClipWrapper`` on
    its device from ``paths.clip_model`` (random weights with a warning
    where there is no checkpoint); without it, none."""
    from vilgod_tpu_torch.models import clip_wrapper

    made = []

    class Recording:
        def __init__(self, clip_cfg, **kwargs):
            made.append((clip_cfg, kwargs))

    monkeypatch.setattr(clip_wrapper, "ClipWrapper", Recording)
    logger = T.create_logger("vilgod_tpu_torch.test_tools")
    ckpt = tmp_path / "ViT-B-16.pt"
    cfg = R.build_config({"preprocessor": "synthetic",
                          "paths": {"clip_model": str(ckpt)}})
    with caplog.at_level(logging.WARNING, logger=logger.name):
        assert isinstance(R.build_clip_model(cfg, torch.device("cpu"),
                                             logger), Recording)
    assert made[0][0] == cfg["preprocessor"]["clip"]
    assert made[0][1]["checkpoint_path"] == str(ckpt)
    assert made[0][1]["device"] == torch.device("cpu")
    assert "random weights" in caplog.text
    geo = R.build_config({"pipeline_active": ["mask_ground_points"]})
    assert R.build_clip_model(geo, torch.device("cpu"), logger) is None


SMOKE_CAPS = {"max_points": 4096, "max_ng_points": 2048, "max_clusters": 16,
              "max_cluster_points": 512, "max_tracks": 16,
              "max_cluster_input": 2048, "clip_batch": 4}
GEOMETRY = ["mask_ground_points", "calculate_entropy_scores",
            "spatial_clustering", "filter_detections", "track_clusters",
            "fit_bounding_boxes_simple", "propagate_labels",
            "evaluate_sequence"]


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """The tool on the CPU over tests/test_pipeline_e2e.py's smoke scene
    (geometry stages), with a results directory and ``profile_dir``."""
    out = tmp_path_factory.mktemp("run")
    results = R.main([
        "preprocessor=synthetic", "device=cpu", "random_seed=11",
        "synthetic.n_frames=6", "synthetic.n_ground=900",
        "synthetic.n_vehicles=1", "synthetic.n_pedestrians=0",
        "synthetic.n_moving=0", f"capacity={SMOKE_CAPS!r}",
        f"pipeline_active={GEOMETRY!r}", f"paths.results={out / 'results'}",
        f"paths.sequence_data={out / 'cache'}", f"profile_dir={out / 'trace'}"])
    return out, results


def test_run_tool_writes_ap_results(smoke_run):
    out, results = smoke_run
    assert len(results) == 6
    assert sum(len(r["name"]) for r in results) >= 3
    ap = json.loads((out / "results" / "ap_results.json").read_text())
    assert ap["OBJECT_TYPE_TYPE_VEHICLE_LEVEL_2/AP"] > 0.5
    assert (out / "results" / "synth_0.npz").exists()
    assert (out / "cache" / "synth_0.npz").exists()


def test_profile_dir_trace_names_each_stage(smoke_run):
    """``profile_dir``: a Chrome trace per sequence, one span per active
    stage, each about as long as the stage took."""
    out, _ = smoke_run
    trace = json.loads((out / "trace" / "synth_0.trace.json").read_text())
    spans = {e["name"]: e["dur"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert set(GEOMETRY) <= set(spans)
    assert spans["spatial_clustering"] > 1e3        # us


def test_no_trace_without_profile_dir(tmp_path):
    """Without ``profile_dir`` nothing is traced or written, and a profiler
    the caller runs sees no stage span (as ``chip_smoke.py``'s busy share
    counts every device range)."""
    from torch.profiler import ProfilerActivity, profile
    from vilgod_tpu_torch.config import waymo_config
    from vilgod_tpu_torch.data import SyntheticDataset
    from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector

    cfg = waymo_config(capacity=SMOKE_CAPS,
                       pipeline_active=["mask_ground_points"])
    seq = SyntheticDataset(n_sequences=1, n_frames=2, seed=11,
                           n_ground=900).sequence("synth_0")
    zsd = ZeroShotDetector(seq, "synth_0", cfg, cache_dir=tmp_path,
                           device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        zsd.process()
    assert "mask_ground_points" not in {e.name for e in prof.events()}
    assert set(zsd.stage_times) == {"mask_ground_points"}
    assert [p.name for p in tmp_path.iterdir()] == ["synth_0.npz"]


SMOKE_SCENE = dict(n_sequences=1, n_frames=6, n_ground=900, n_vehicles=1,
                   n_pedestrians=0, n_moving=0, seed=11)


@pytest.fixture(scope="module")
def waymo_run(tmp_path_factory):
    """The smoke scene exported to the Waymo layout (its GT as labels, its
    object indices as track ids) and run from disk by the tool, as
    ``smoke_run`` runs it from the generator."""
    from vilgod_tpu_torch.data import SyntheticDataset
    from vilgod_tpu_torch.data.export import export_pseudo_dataset

    root = tmp_path_factory.mktemp("waymo")
    seq = SyntheticDataset(**SMOKE_SCENE).sequence("synth_0")
    labels, tids = [], []
    for f in range(SMOKE_SCENE["n_frames"]):
        gt = seq.get_annos(f)
        labels.append({"boxes_lidar": gt["gt_boxes_lidar"], "name": gt["gt_names"],
                       "score": np.ones(len(gt["gt_names"]), np.float32),
                       "moving": gt["moving"]})
        tids.append(np.arange(len(gt["gt_names"])))
    export_pseudo_dataset(SyntheticDataset(**SMOKE_SCENE), {"synth_0": labels},
                          root / "data", track_ids_by_sequence={"synth_0": tids})
    out = root / "out"
    results = R.main([
        "preprocessor=waymo", "device=cpu", f"paths.data={root / 'data'}",
        "split=pseudo", "random_seed=11", f"capacity={SMOKE_CAPS!r}",
        f"pipeline_active={GEOMETRY!r}", f"paths.results={out / 'results'}",
        f"paths.sequence_data={out / 'cache'}"])
    return root, results


def test_run_tool_from_waymo_layout_matches_synthetic(smoke_run, waymo_run):
    """``preprocessor=waymo`` reads the export and writes
    ``ap_results.json``; its detections, boxes, scores and every stage
    output of the checkpoint equal the run on the generator's frames."""
    out, syn = smoke_run
    root, real = waymo_run
    assert (root / "out" / "results" / "ap_results.json").exists()
    assert len(real) == len(syn) == SMOKE_SCENE["n_frames"]
    for a, b in zip(real, syn):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with np.load(out / "cache" / "synth_0.npz") as a, \
            np.load(root / "out" / "cache" / "synth_0.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _evaluate_both(capsys, args):
    """The port's evaluate CLI and the JAX package's on the same flags:
    (the port's APs, its stdout, the JAX tool's stdout)."""
    from vilgod_tpu_torch.tools import evaluate as E

    ap = E.main(args)
    port_out = capsys.readouterr().out
    _jax_tool("evaluate").main(args)
    return ap, port_out, capsys.readouterr().out


def test_evaluate_cli_rescoring_matches_jax_and_run_tool(waymo_run, capsys):
    """On the run tool's results directory: both CLIs print the same AP
    table and cluster line, and the APs equal ``ap_results.json``."""
    root, _ = waymo_run
    args = ["--results", str(root / "out" / "results"), "--data",
            str(root / "data"), "--split", "pseudo", "--cluster-eval"]
    ap, port_out, jax_out = _evaluate_both(capsys, args)
    assert port_out == jax_out
    assert "synth_0: box_recall=" in port_out and "Vehicle AP" in port_out
    written = json.loads((root / "out" / "results" / "ap_results.json").read_text())
    assert ap.keys() == written.keys()
    for k in ap:
        assert ap[k] == pytest.approx(written[k], abs=1e-6), k
    for flags in (["--moving"], ["--static", "--bev"], ["--class-agnostic"],
                  ["--iou", "0.7", "--score-thresh", "0.5"]):
        _, port_out, jax_out = _evaluate_both(capsys, args[:-1] + flags)
        assert port_out == jax_out, flags


def test_evaluate_cli_reads_jax_schema_results(waymo_run, tmp_path, capsys):
    """A results directory in the JAX runner's schema (``results``: an
    object array of frame dicts, written as the JAX runner writes it) and
    a pickle of frame dicts: both CLIs agree; perfect labels score 1."""
    import pickle
    from vilgod_tpu.data import WaymoSequenceDataset

    root, _ = waymo_run
    seq = WaymoSequenceDataset(root / "data", split="pseudo").sequence("synth_0")
    frames = []
    for f in range(seq.sequence_length):
        gt = seq.get_annos(f)
        frames.append({"boxes_lidar": gt["gt_boxes_lidar"].astype(np.float32),
                       "name": gt["gt_names"],
                       "score": np.full(len(gt["gt_names"]), 0.9, np.float32)})
    (tmp_path / "npz").mkdir()
    np.savez_compressed(tmp_path / "npz" / "synth_0.npz",
                        results=np.array(frames, dtype=object))
    with open(tmp_path / "synth_0.pkl", "wb") as fp:
        pickle.dump(frames, fp)
    for results in (tmp_path / "npz", tmp_path / "synth_0.pkl"):
        args = ["--results", str(results), "--data", str(root / "data"),
                "--split", "pseudo"]
        ap, port_out, jax_out = _evaluate_both(capsys, args)
        assert port_out == jax_out
        assert ap["OBJECT_TYPE_TYPE_VEHICLE_LEVEL_2/AP"] == pytest.approx(1.0)


def test_evaluate_cli_without_overlap_exits(waymo_run, tmp_path):
    from vilgod_tpu_torch.tools import evaluate as E

    root, _ = waymo_run
    with pytest.raises(SystemExit, match="no overlapping sequences"):
        E.main(["--results", str(tmp_path), "--data", str(root / "data"),
                "--split", "pseudo"])


# ---------------------------------------------------------------------------
# the measurement tools: profile_trace, profile_stages, reconcile_timing,
# certify_tf, microbench
# ---------------------------------------------------------------------------

TINY_CAPS = {"max_points": 4096, "max_ng_points": 2048, "max_clusters": 16,
             "max_cluster_points": 512, "max_tracks": 16,
             "max_cluster_input": 4096, "clip_batch": 4}
TINY_STAGES = ["mask_ground_points", "calculate_entropy_scores",
               "spatial_clustering"]


@pytest.fixture
def tiny_build(monkeypatch):
    """``tools.bench``'s smoke scale cut to a 2-frame scene and stages 1-3
    with no tower, for the tools that run it."""
    from vilgod_tpu_torch.config import waymo_config
    from vilgod_tpu_torch.data import SyntheticDataset
    from vilgod_tpu_torch.tools import bench

    def build(scale):
        return (waymo_config(capacity=TINY_CAPS, pipeline_active=TINY_STAGES),
                SyntheticDataset(n_sequences=1, n_frames=2, seed=11,
                                 n_ground=600, n_vehicles=1), None)

    monkeypatch.setattr(bench, "build", build)
    monkeypatch.setattr(bench, "clip_model_for", lambda *a: None)


def test_profile_trace_aggregates_a_cpu_trace(smoke_run, capsys):
    """The trace the runner wrote for the smoke run (a CPU run: no card
    events) aggregates by the CPU's operators; ``main --trace`` prints the
    table and a JSON line last."""
    from vilgod_tpu_torch.tools import profile_trace as P

    out, _ = smoke_run
    path = out / "trace" / "synth_0.trace.json"
    trace = json.loads(path.read_text())
    rows, cats = P.aggregate(trace)
    assert cats == P.CPU_CATEGORIES
    names = [r[0] for r in rows]
    assert len(names) == len(set(names)) and any(n.startswith("aten::")
                                                 for n in names)
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)
    ops = [e for e in trace["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert sum(r[2] for r in rows) == len(ops)
    assert sum(r[1] for r in rows) == pytest.approx(
        sum(e["dur"] for e in ops) / 1e6)
    assert P.main(["--trace", str(path), "--top", "5"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert len(line["top"]) == 5 and line["categories"] == ["cpu_op"]
    assert line["top"][0]["name"] == rows[0][0]
    assert len(lines) == 1 + 2 + 5


def test_profile_trace_prefers_the_cards_work():
    """In a trace with kernels, copies or sets, only those count; launch
    counts and totals by name."""
    from vilgod_tpu_torch.tools import profile_trace as P

    ev = [{"ph": "X", "cat": "kernel", "name": "count_kernel<3, 1>",
           "dur": 5.0}] * 3 + [
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "spatial_clustering",
         "dur": 500.0},
        {"ph": "i", "cat": "kernel", "name": "marker"}]
    rows, cats = P.aggregate({"traceEvents": ev})
    assert cats == P.DEVICE_CATEGORIES
    assert rows == [("Memcpy HtoD", pytest.approx(20e-6), 1),
                    ("count_kernel<3, 1>", pytest.approx(15e-6), 3)]


def test_profile_stages_prints_cold_and_warm(tiny_build, capsys):
    from vilgod_tpu_torch.tools import profile_stages as S

    assert S.main(["--scale", "smoke"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    budgets = json.loads(out[-1])["budgets"]
    assert [b["name"] for b in budgets] == ["cold", "warm"]
    for b in budgets:
        assert set(b["stage_s"]) == set(TINY_STAGES) and b["frames"] == 2
        assert 0 < sum(b["stage_s"].values()) <= b["wall_s"]
    assert out[0].startswith("== cold: wall=")
    assert sum(line.startswith("  mask_ground_points") for line in out) == 2


def test_reconcile_timing_rows_sum_to_the_adjusted_wall(tiny_build, capsys):
    """The prefix rows and the setup row sum to the adjusted wall of the
    whole pipeline (by construction), each prefix's adjusted wall is its
    wall less the idle sync, and the bench's budget prints beside it."""
    from vilgod_tpu_torch.tools import reconcile_timing as RT

    assert RT.main(["--scale", "smoke", "--passes", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    rows = line["stage_ms_per_frame"]
    assert list(rows) == TINY_STAGES
    assert line["setup_ms_per_frame"] + sum(rows.values()) == pytest.approx(
        line["sum_check_ms_per_frame"], abs=0.01)
    assert set(line["bench_stage_ms_per_frame"]) >= set(TINY_STAGES) | {
        "host_setup_and_gaps"}
    assert any(r.startswith("spatial_clustering") for r in out)

    # the rows are the differences of the best prefix walls
    walls = iter([5.0, 7.0, 6.0, 9.0, 10.0, 8.0, 12.0, 13.0])

    def runner(cfg, seq, name, clip, device, k):
        w = next(walls)
        return {"adj_s": w - 0.5, "total_s": w, "sync1_s": 0.1,
                "sync2_s": 0.5}

    cfg = {"pipeline_active": TINY_STAGES}
    b = RT.prefix_budget(cfg, None, "s", None, torch.device("cpu"), passes=2,
                         runner=runner)
    assert [p["adj_s"] for p in b["prefixes"]] == [4.5, 5.5, 7.5, 11.5]
    assert b["stage_s"] == {"mask_ground_points": 1.0,
                            "calculate_entropy_scores": 2.0,
                            "spatial_clustering": 4.0}
    assert b["setup_s"] + sum(b["stage_s"].values()) == b["adj_total_s"]


def test_certification_fixture_pins_the_ports_ap(tmp_path, capsys):
    """The port's numpy AP on the committed certification fixture equals
    tests/fixtures/tf_cert_expected.json to 1e-5 (as tests/test_waymo_tf.py
    holds the JAX package's); the CLI says the TF diff waits for
    waymo_open_dataset; ``--regen`` writes only where it is told, the same
    fixture; a drifted pin fails the CLI."""
    from vilgod_tpu_torch.eval import waymo_detection_ap
    from vilgod_tpu_torch.eval.waymo_tf import tf_available
    from vilgod_tpu_torch.tools import certify_tf as C

    assert C.FIXTURE == REPO / "tests" / "fixtures" / "tf_cert_annos.npz"
    assert C.FIXTURE.exists() and C.EXPECTED.exists()
    det_annos, gt_annos = C.load_fixture()
    ap = waymo_detection_ap(det_annos, gt_annos)
    expected = json.loads(C.EXPECTED.read_text())
    assert len(expected) >= 6
    for k, v in expected.items():
        assert ap[k] == pytest.approx(v, abs=1e-5), k
    assert C.numpy_drift(ap, expected) == {}

    assert C.main([]) == 0
    out = capsys.readouterr().out
    assert "matches" in out
    if not tf_available():
        assert "waymo_open_dataset is not available" in out

    assert C.main(["--regen", str(tmp_path)]) == 0
    det2, gt2 = C.load_fixture(tmp_path / C.FIXTURE.name)
    for a, b in zip(det_annos + gt_annos, det2 + gt2):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    regen = json.loads((tmp_path / C.EXPECTED.name).read_text())
    assert regen.keys() == expected.keys()
    for k in expected:
        assert regen[k] == pytest.approx(expected[k], abs=2e-6)

    moved = dict(expected)
    key = next(iter(moved))
    moved[key] += 1e-3
    (tmp_path / "moved.json").write_text(json.dumps(moved))
    assert C.main(["--expected", str(tmp_path / "moved.json")]) == 1
    assert key in capsys.readouterr().out


def test_microbench_smoke(monkeypatch, capsys):
    """The microbench's sections on the CPU over a small scene: a row per
    part, the chained scan at each k, the propagation's rounds, one JSON
    line last; no kernel launches on the CPU."""
    from vilgod_tpu_torch.config import waymo_config
    from vilgod_tpu_torch.data import SyntheticDataset
    from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector
    from vilgod_tpu_torch.tools import microbench as M

    def build_state(scale, device):
        cfg = waymo_config(capacity=TINY_CAPS)
        seq = SyntheticDataset(n_sequences=1, n_frames=4, seed=11,
                               n_ground=600, n_vehicles=1).sequence("synth_0")
        return ZeroShotDetector(seq, "synth_0", cfg,
                                device=device).state, cfg

    monkeypatch.setattr(M, "build_state", build_state)
    assert M.main(["--scale", "smoke", "--reps", "1", "--chains", "1,2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rows = json.loads(out[-1])["rows"]
    parts = [r["part"] for r in rows]
    assert parts[:4] == ["ground presort (batched 3-key sort, all frames)",
                         "ground state scan (given presort)",
                         "ground chained scan k=1 (8 frames)",
                         "ground chained scan k=2 (8 frames)"]
    for want in ("entropy_sequence", "dbscan_labels_paged", "count3 pass",
                 "min-label pass", "propagation", "nearest pass",
                 "knn_labels_paged", "render_cluster_views",
                 "ViT image encode"):
        assert any(want in p for p in parts), want
    assert all(r["ms"] > 0 and r["launches"] == {} for r in rows)
    rounds = [r["rounds"] for r in rows if "rounds" in r]
    assert len(rounds) == 1 and rounds[0] >= 1
    assert sum(line.startswith("== ") for line in out) == 4
