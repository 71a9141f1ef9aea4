"""The port's run tool (``vilgod_tpu_torch.tools.run``), its
``utils/common`` helpers, and the runner's ``profile_dir`` trace.

The helpers are held against the JAX package's own (``vilgod_tpu.utils``)
on tests/test_tools.py's oracles and on random inputs; ``parse_overrides``
against the JAX tool's on tests/test_tools.py's cases; the tool runs the
geometry stages on the CPU on tests/test_pipeline_e2e.py's smoke scene,
writes ``ap_results.json`` and, with ``profile_dir``, a trace with one span
per active stage."""
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


def _jax_run_tool():
    spec = importlib.util.spec_from_file_location("jax_run",
                                                  REPO / "tools" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    """The real-data adapters are not ported: their preprocessors raise,
    naming the ROADMAP item, and never fall back to the synthetic scene
    (with a data path or without)."""
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        R.main([f"preprocessor={preset}", "device=cpu"])
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        R.main([f"preprocessor={preset}", "device=cpu",
                f"paths.data={tmp_path}"])


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
