"""The port's soak (``vilgod_tpu_torch.tools.soak``) on the CPU: its checks
at the ``--smoke`` caps on a short sequence (two same-bucket sequences, no
capacity saturated, detections to the end, no kernel build or library
load in the second); each check fails where it should; and the build
counter of ``utils/cuda_build`` that stands in for the JAX soak's "zero
recompiles": a second ``load()`` of a library does not build."""
import json
import sys

import pytest
import torch

from vilgod_tpu_torch.tools import soak
from vilgod_tpu_torch.utils import cuda_build

N_FRAMES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def report():
    """The soak at the smoke caps: 8-frame sequences of a lighter smoke
    scene with a 4-frame entropy window (the checks are the tool's; the
    window's length is the bench's business), on the CPU."""
    cfg = soak.build_cfg(smoke=True)
    for p in cfg["pipeline"]:
        if p["name"] == "calculate_entropy_scores":
            p.setdefault("args", {})["n_neighbouring_frames"] = 4
    return soak.soak(cfg, {**soak.SMOKE_SCENE, "n_ground": 1500}, N_FRAMES,
                     torch.device("cpu"))


def test_soak_smoke_checks_hold(report):
    assert report["device"] == "cpu" and report["frames"] == N_FRAMES
    assert report["seeds"] == [21, 22]
    for run in (report["cold"], report["warm"]):
        assert run["builds"] == 0 and run["loads"] == 0
        assert run["peak_gib"] is None                # no card
        assert 0 < run["clusters_used"] < run["max_clusters"]
        assert 0 < run["tracks"] < run["max_tracks"]
        assert run["dets_last_frames"] > 0 and run["last_frames"] == N_FRAMES
        assert set(run["stage_s"]) == set(soak.STAGES)
        assert run["frames_per_s"] == pytest.approx(N_FRAMES / run["wall_s"])
        assert run["ng_bucket"] >= run["ng_points_max"] > 0
    lines = soak.report_lines(report)
    assert lines[0].startswith("# Soak: 8 frames")
    assert any(line.startswith("| mask_ground_points (s) |") for line in lines)


def _run(**kw):
    return {"builds": 0, "loads": 0, "peak_bytes": 1000, **kw}


@pytest.mark.parametrize("warm,message", [
    (_run(builds=1), "built 1"),
    (_run(loads=1), "loaded 1"),
    (_run(peak_bytes=1051), "peak memory moved"),
], ids=["build", "load", "peak"])
def test_warm_checks_fail(warm, message):
    soak.warm_checks(_run(peak_bytes=1000), _run(peak_bytes=1049))
    with pytest.raises(AssertionError, match=message):
        soak.warm_checks(_run(), warm)


class _State:
    """A sequence's state reduced to what the capacity checks read."""

    def __init__(self, labels_max, tracks, max_clusters=64, max_tracks=512):
        import numpy as np
        from vilgod_tpu_torch.pipeline.state import Capacity
        self.det_n = np.ones((4, 2), np.int32)
        self.labels = np.full((4, 8), labels_max, np.int32)
        self.caps = Capacity(max_clusters=max_clusters, max_tracks=max_tracks)
        self.tracks = type("P", (), {"valid_tracks": lambda s: list(range(tracks))})()
        self.points_mask = np.ones((4, 8), bool)
        self._ng_counts = np.full(4, 8)

    def points_bucket(self):
        return 8192

    def ng_bucket(self):
        return 8192


@pytest.mark.parametrize("state,dets,message", [
    (_State(63, 3), 1, "cluster table saturated"),
    (_State(5, 512), 1, "track pool saturated"),
    (_State(5, 0), 1, "track pool saturated"),
    (_State(5, 3), 0, "no detections in the final 4"),
], ids=["clusters", "tracks-full", "no-tracks", "late"])
def test_capacity_checks_fail(state, dets, message):
    import numpy as np
    results = [{"boxes_lidar": np.zeros((dets, 7))} for _ in range(4)]
    ok = soak.capacity_checks({"state": _State(5, 3), "results": [
        {"boxes_lidar": np.zeros((1, 7))}] * 4}, 4)
    assert ok["clusters_used"] == 6 and ok["tracks"] == 3
    with pytest.raises(AssertionError, match=message):
        soak.capacity_checks({"state": state, "results": results}, 4)


def test_main_prints_and_writes_only_to_out(monkeypatch, tmp_path, capsys):
    """``main`` prints the report's table and one JSON line last, writes
    the table only where ``--out`` says, and exits 1 on a failed check."""
    fake = {"device": "cpu", "frames": 3, "seeds": [21, 22]}
    for name in ("cold", "warm"):
        fake[name] = {"wall_s": 1.0, "frames_per_s": 3.0,
                      "build_state_s": 0.1, "peak_gib": None, "builds": 0,
                      "loads": 0, "clusters_used": 2, "tracks": 1,
                      "dets_last_frames": 2,
                      "stage_s": {"mask_ground_points": 0.5}}
    monkeypatch.setattr(soak, "soak", lambda *a, **k: fake)
    assert soak.main(["--smoke", "--frames", "3"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == fake and out[0].startswith("# Soak")
    assert list(tmp_path.iterdir()) == []
    path = tmp_path / "soak.md"
    assert soak.main(["--smoke", "--out", str(path)]) == 0
    assert path.read_text().startswith("# Soak: 3 frames")

    def fail(*a, **k):
        raise AssertionError("track pool saturated")
    monkeypatch.setattr(soak, "soak", fail)
    assert soak.main(["--smoke"]) == 1
    assert "track pool saturated" in capsys.readouterr().err


def test_second_load_does_not_build(monkeypatch, tmp_path):
    """``CudaLibrary.load``: the first load of a source builds it (one nvcc,
    counted in ``BUILDS``) and loads it (``LOADS``); a second load of the
    same library neither builds nor loads; a new library object of the same
    source loads the built file without building."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('so')\n")
    nvcc.chmod(0o755)
    source = tmp_path / "k.cu"
    source.write_text("// a kernel\n")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "BUILDS", {})
    monkeypatch.setattr(cuda_build, "LOADS", {})
    loaded = []
    monkeypatch.setattr(cuda_build.ctypes, "CDLL",
                        lambda path: loaded.append(path) or object())

    lib = cuda_build.CudaLibrary(str(source), {})
    first = lib.load()
    assert cuda_build.BUILDS == {"k.cu": 1} and cuda_build.LOADS == {"k.cu": 1}
    assert lib.path.exists() and loaded == [str(lib.path)]
    assert lib.load() is first
    assert cuda_build.BUILDS == {"k.cu": 1} and cuda_build.LOADS == {"k.cu": 1}
    cuda_build.CudaLibrary(str(source), {}).load()
    assert cuda_build.BUILDS == {"k.cu": 1} and cuda_build.LOADS == {"k.cu": 2}
    # an edited source is another library: it builds
    source.write_text("// another kernel\n")
    cuda_build.CudaLibrary(str(source), {}).load()
    assert cuda_build.BUILDS == {"k.cu": 2}
