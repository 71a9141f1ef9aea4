"""The spans pass's reduction (``benchmark/spans.py``) and the span
metrics' readers: idle time put down to the innermost open span, the
stage markers' offsets, the banded kernels told apart from the dense ones
by their signatures in the CUDA sources, a launch's least time by hand,
every reader silent without spans, and one spans pass of the tiny cell on
the CPU."""
import re
import types

import pytest
import torch

from benchmark import harness, spans
from benchmark.metrics import read
from benchmark.trace import NEIGHBOUR_CU

READERS = ["prefetch_wait_ms_per_frame", "host_syncs_per_frame",
           "ground_scan_idle_ms_per_frame", "cluster_select_ms_per_frame",
           "ransac_draw_ms_per_frame", "classify_render_ms_per_frame",
           "classify_padded_pct", "banded_roofline"]


def _span(i, name, parent, a, b, thread="MainThread"):
    return types.SimpleNamespace(id=i, name=name, parent=parent,
                                 thread=thread, start_ns=a, end_ns=b)


MS = 1_000_000


def test_idle_goes_to_the_innermost_span():
    """sequence [0, 100) ms; stage A [0, 60) holds sub [10, 40); stage B
    [60, 100); a worker thread's span is ignored. The profiler's clock
    reads 5 ms ahead of the recorder's: the markers, launched at 1 (in A),
    60 (in B) and 100 (the end, after the sequence), start at 6, 65 and
    105; on the recorder's clock the card is busy over [0, 5), [20, 30)
    and [70, 75) besides."""
    ss = [_span(0, "sequence", None, 0, 100 * MS),
          _span(1, "A", 0, 0, 60 * MS), _span(2, "sub", 1, 10 * MS, 40 * MS),
          _span(3, "B", 0, 60 * MS, 100 * MS),
          _span(4, "build", None, 0, 100 * MS, thread="worker")]
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [(n, a * MS, b * MS) for n, a, b in (
        ("k", 5, 10), (spin, 6, 7), ("k", 25, 35), (spin, 65, 66),
        ("k", 75, 80), (spin, 105, 106), ("k", 125, 135))]
    stamps = [1 * MS, 60 * MS, 100 * MS]
    out = spans.attribute(events, ss, stamps)
    ms = lambda d: {k: round(v * 1e3, 6) for k, v in d.items()}  # noqa: E731
    # A's own: [5, 10) and [40, 60); sub: [10, 20) and [30, 40); B: [61,
    # 70) and [75, 100)
    assert ms(out["idle_by_path"]) == {"A": 25, "A/sub": 20, "B": 34}
    assert round(out["busy_s"] * 1e3, 6) == 21
    assert round(out["window_s"] * 1e3, 6) == 100
    assert round(out["clock_offset_s"] * 1e3, 6) == 5
    assert out["markers"] == dict(launched=3, traced=3, paired=3)
    assert ms(out["marker_offsets_s"]) == {"A": 6, "B": 5}
    assert ms(out["marker_offsets_aligned_s"]) == {"A": 1, "B": 0}
    assert out["banded_cu_s"] == 0.0
    # a trace that loses the first marker, or one in the middle: the
    # others still pair with their own stamps
    for lost, left in ((1, {"B": 0}), (3, {"A": 1})):
        out = spans.attribute(events[:lost] + events[lost + 1:], ss, stamps)
        assert out["markers"] == dict(launched=3, traced=2, paired=2)
        assert ms(out["marker_offsets_aligned_s"]) == left
        assert round(out["clock_offset_s"] * 1e3, 6) == 5
    # without stamps nothing is paired or moved
    out = spans.attribute(events, ss)
    assert out["clock_offset_s"] is None and out["marker_offsets_s"] == {}


def test_markers_pair_by_the_nearest_stamp():
    """Stamps 10 ms apart; the trace lost the second marker, the third
    reads 0.4 ms before its stamp, the rest 80 us after theirs: the map is
    the median lag, 80 us, with no drift, and each marker keeps its
    stamp."""
    stamps = [0, 10 * MS, 20 * MS, 30 * MS, 40 * MS]
    marks = [80_000, 20 * MS - 400_000, 30 * MS + 80_000, 40 * MS + 80_000]
    clock, pairs = spans.pair_markers(marks, stamps)
    assert clock == (0, 80_000, 0.0)
    assert pairs == [(0, marks[0]), (2, marks[1]), (3, marks[2]),
                     (4, marks[3])]
    # two markers nearest one stamp: the nearer keeps it; one too far
    # from every stamp pairs with none
    clock, pairs = spans.pair_markers([100, 5 * MS + 100, 5 * MS + 300,
                                       9 * MS], [0, 5 * MS])
    assert pairs == [(0, 100), (1, 5 * MS + 100)] and clock == (0, 100, 0.0)
    assert spans.pair_markers([], stamps) == (None, [])


def test_the_clock_map_follows_a_drift():
    """The profiler's clock gains 50 us on the host's over each second
    (50 ppm) from 60 us ahead, and one marker reads 0.5 ms early: the map
    finds both, pairs every marker, and takes the drift off the stages'
    markers; a single offset would leave them 0.25 ms apart."""
    s = 1000 * MS
    stamps = [k * s for k in range(11)]
    marks = [h + 60_000 + h // 20_000 for h in stamps]
    marks[4] -= 500_000
    (t_ref, offset, drift), pairs = spans.pair_markers(marks, stamps)
    assert (t_ref, offset) == (0, 60_000) and drift == pytest.approx(5e-5)
    assert [i for i, _ in pairs] == list(range(11))
    ss = [_span(0, "sequence", None, 0, 10 * s + 1)] + [
        _span(k + 1, f"s{k}", 0, k * s, (k + 1) * s) for k in range(10)]
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    out = spans.attribute([(spin, m, m + 1000) for m in marks], ss, stamps)
    us = {k: round(v * 1e6, 3) for k, v in
          out["marker_offsets_aligned_s"].items()}
    # the early marker's 0.5 ms, read on the host's slower clock
    assert us == {f"s{k}": (-499.975 if k == 4 else 0) for k in range(10)}
    assert out["clock_drift_ppm"] == pytest.approx(50)


def test_a_gap_outside_every_span():
    ss = [_span(0, "sequence", None, 0, 100), _span(1, "A", 0, 10, 50)]
    out = spans.attribute([("k", 50, 60)], ss)
    idle = {k: round(v * 1e9) for k, v in out["idle_by_path"].items()}
    assert idle == {"sequence": 50, "A": 40}


def _signatures(source: str):
    """Each ``__global__`` kernel of a CUDA source as the profiler names
    it: ``void (anonymous namespace)::name<3, 1>(float const*, int, ...)``
    (pointer qualifiers before the type move after it, ``__restrict__``
    and parameter names go)."""
    out = []
    for tmpl, name, params in re.findall(
            r"template <([^>]*)>\s*__global__ void __launch_bounds__\([^)]*"
            r"\)\s*(\w+)\(([^)]*)\)", source):
        types_ = []
        for p in params.split(","):
            p = p.replace("__restrict__", "").split()
            t = " ".join(p[:-1])
            if t.startswith("const "):
                t = t[len("const "):].rstrip("*") + " const*"
            types_.append(t.replace(" *", "*"))
        args = ", ".join(str(3 + k) for k in range(len(tmpl.split(","))))
        out.append((name, f"void (anonymous namespace)::{name}<{args}>("
                          + ", ".join(types_) + ")"))
    return out


def test_the_banded_regex_tells_the_two_sources_apart():
    from pathlib import Path
    csrc = Path(spans.__file__).resolve().parents[1] / \
        "vilgod_tpu_torch" / "csrc"
    banded = _signatures((csrc / "banded.cu").read_text())
    dense = _signatures((csrc / "dense.cu").read_text())
    assert sorted(n for n, _ in banded) == ["count_kernel", "min_label_kernel",
                                            "nearest_kernel"]
    assert {"count_kernel", "min_label_kernel", "nearest_kernel"} <= \
        {n for n, _ in dense}
    for _, sig in banded:
        assert spans.BANDED_CU.match(sig), sig
        assert NEIGHBOUR_CU.match(sig), sig
    for _, sig in dense:
        assert not spans.BANDED_CU.match(sig), sig
    assert banded[0][1].startswith(
        "void (anonymous namespace)::count_kernel<3, 4>(float const*, int, "
        "float const*, int, int const*, int const*, int, int, int, float,")


def test_banded_bound_by_hand():
    peak = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    # kernel 1, 1e9 pairs in 3 dimensions: 9 operations a pair, 9e9 over
    # 67 TFLOP/s; its bytes (12 B a point of both clouds, 4 a count)
    # take far less
    b = spans.banded_bound_s("banded_tile_count", 10**9, 3, 40960, 40960,
                             peak)
    assert b == pytest.approx(9e9 / 67e12, rel=1e-12)
    # a launch of few pairs is bound by its bytes: the min-label pass
    # reads its cloud (6 rows), radii and labels once, writes labels
    b = spans.banded_bound_s("banded_tile_min_label", 10, 6, 1000, 1000,
                             peak)
    assert b == pytest.approx((24 + 8 + 4) * 1000 / 3.35e12, rel=1e-12)
    b = spans.banded_bound_s("banded_tile_nearest", 10, 4, 100, 300, peak)
    assert b == pytest.approx((16 * 400 + 8 * 100) / 3.35e12, rel=1e-12)
    b = spans.banded_bound_s("banded_tile_count3", 2 * 10**8, 6, 1, 1, peak)
    assert b == pytest.approx(2e8 * 20 / 67e12, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_every_reader_is_silent_without_spans(name):
    ctx = dict(frames=10, window_s=1.0, stage_s={}, trace=None)
    assert read(name, ctx) is None
    empty = dict(frames=10, idle_by_path={}, wall_s={}, device_s={},
                 counters={}, syncs=0, banded_cu_s=0.0, banded_bound_s=None)
    if name not in ("host_syncs_per_frame", "prefetch_wait_ms_per_frame"):
        assert read(name, dict(ctx, spans=empty)) is None


def test_a_spans_pass_of_the_tiny_cell_on_the_cpu(tiny_root):
    """The spans pass after a window of the tiny cell, on the CPU: every
    span the metrics read is there, the readers read them (the banded
    roofline, with no card's peak, stays silent), and nothing of the
    window moved."""
    torch.set_num_threads(4)
    out = harness.run("tiny", 77, 0.0, False, "cpu", workers=2,
                      root=tiny_root)
    n_window = len(out["rec"].sequences)
    sp = spans.spans_pass(out["rec"], out["cfg"], out["clip"], out["seqs"][0],
                          torch.device("cpu"))
    assert len(out["rec"].sequences) == n_window and sp["events"] == []
    s = spans.summarize(sp["trace"], sp["events"], sp["frames"], None)
    names = set(s["wall_s"])
    assert {"sequence", "mask_ground_points", "ground.presort", "ground.scan",
            "ground.compact", "cluster.stats", "cluster.chunk",
            "cluster.select", "cluster.dbscan", "cluster.download",
            "filter.plane", "filter.ransac_draw", "filter.segments",
            "filter.download", "filter.combine", "classify.batch",
            "classify.render", "classify.tower",
            "classify.vote"} <= names
    assert s["by_kernel"] and s["banded_bound_s"] is None
    assert all(k["launches"] > 0 and k["pairs"] > 0
               for k in s["by_kernel"].values())
    assert s["syncs"] == 0                  # no sync mode on the CPU
    assert abs(sum(s["idle_by_path"].values()) - s["window_s"]) < 1e-6
    assert set(s["marker_offsets_s"]) == set()
    ctx = dict(frames=8, prefetch_wait_s=0.0, spans=s)
    values = {n: read(n, ctx) for n in READERS}
    assert values["banded_roofline"] is None
    assert values["host_syncs_per_frame"] == 0.0
    assert values["prefetch_wait_ms_per_frame"] == 0.0
    for n in READERS[2:7]:
        assert values[n] is not None and values[n] >= 0, n
    c = s["counters"]["classify.batch"]
    assert c["items_run"] >= c["items_needed"] > 0
