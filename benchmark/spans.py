"""The spans pass: the window's first sequence once more under the device
profiler (the card's activity only) with the same stage markers and the
program's span recorder on (``vilgod_tpu_torch.utils.trace``), and the
reduction of its events and spans to what the span metrics read
(``benchmark/metrics/``: ``ctx["spans"]`` and ``ctx["prefetch_wait_s"]``).

    python3 -m benchmark.spans --workload waymo.urban --seed 1 --seconds 45

runs a cell as ``benchmark.run --trace 1`` does (set-up, the untraced
window), then the spans pass, then the traced pass (in that order: the
profiler's second session of a process loses records), and prints on standard
error the spans pass's wall beside the traced pass's (the recorder's
on-cost), each stage marker's start less its stage span's start, the
idle spans, the syncs by stage and the pairs by kernel, and as its last
line of standard output one JSON object of the span metrics' values.
It checks nothing: ``benchmark.run`` decides ``correct``.
"""
from __future__ import annotations

import argparse
import bisect
import functools
import json
import re
import statistics
import sys
import time
from collections import defaultdict

from .trace import MARKER, _OWN, _union

# banded.cu's pair-loop kernels (kernels 1-4), told apart from dense.cu's
# kernels of the same names by their arguments: each block's span start
# and end, then tq, w and the run length
BANDED_CU = re.compile(
    _OWN.format("count_kernel|min_label_kernel|nearest_kernel")
    + r"<[^>]*>\(.*int const\*, int const\*, int, int, int[,)]")
# float32 operations per (query, data) pair: (q - d) and its square per
# coordinate, the coordinate sums, then each kernel's epilogue; bytes of
# output per query (chip_smoke.py's counts)
EPILOGUE_OPS = {"banded_tile_count": 1, "banded_tile_count3": 3,
                "banded_tile_min_label": 2, "banded_tile_nearest": 1}
OUT_BYTES = {"banded_tile_count": 4, "banded_tile_count3": 12,
             "banded_tile_min_label": 4, "banded_tile_nearest": 8}
# float32 peaks outside the tensor cores (NVIDIA's data sheet, SXM, dense)
FP32_FLOPS = {"NVIDIA H100 80GB HBM3": 67e12}
OUTSIDE = "(no span)"
# the spans pass's paired readings (a marker right after a synchronize,
# then this long idle) before the sequence
PAIRED_READINGS, PAIRED_GAP_NS = 3, 5_000_000
# a marker pairs with a stamp at most this far from it, the pass's offset
# taken off
MARKER_TOL_NS = 2_000_000


def banded_bound_s(name: str, pairs: int, ndim: int, n_q: int, n_d: int,
                   peak: dict) -> float:
    """The least time of one banded launch: the larger of its pairs'
    operations over the float32 peak and its bytes over the memory
    bandwidth, each input read once and each output written once (the
    min-label pass reads its one cloud with its radii and labels; the
    blocks' starts and ends are left out)."""
    ops = pairs * (3 * ndim - 1 + EPILOGUE_OPS[name])
    if name == "banded_tile_min_label":
        byts = (4 * ndim + 8) * n_q
    else:
        byts = 4 * ndim * (n_q + n_d)
    byts += OUT_BYTES[name] * n_q
    return max(ops / peak["fp32_flops"], byts / peak["hbm_bytes_per_s"])


def _paths(spans):
    """Each span's path below its root (``stage/sub``; a root: its own
    name) and the pieces of its self time (start, end)."""
    by_id = {s.id: s for s in spans}
    kids = defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    out = []
    for s in spans:
        names, a = [], s
        while a.parent is not None:
            names.append(a.name)
            a = by_id[a.parent]
        path = "/".join(reversed(names)) or s.name
        t = s.start_ns
        for k in sorted(kids[s.id], key=lambda k: k.start_ns):
            if k.start_ns > t:
                out.append((t, k.start_ns, path))
            t = max(t, k.end_ns)
        if s.end_ns > t:
            out.append((t, s.end_ns, path))
    return sorted(out)


def pair_markers(marks, stamps, tol_ns=MARKER_TOL_NS):
    """The card's marker starts (profiler clock, ns) paired with the host
    stamps taken right before each marker's launch (``time.time_ns()``),
    and the pass's clock map fitted to the pairs: a marker launched at host
    time ``h`` starts at ``h + offset + drift * (h - t_ref)`` on the
    profiler's clock (its launch delay included). Each marker pairs with
    the stamp nearest it once the map is taken off, if within ``tol_ns``,
    at most one marker a stamp (the nearer), so a marker the trace lost
    leaves its own stamp alone wherever it was. The first map is the
    marker-less-stamp lag that pairs the most markers (the smaller of
    equals); then the map is fitted twice, robustly (Theil-Sen: the median
    of the pairwise slopes, the median intercept). Returns ``(t_ref,
    offset, drift)`` (None without a pair) and the pairs (stamp index,
    marker start)."""
    stamps = list(stamps)
    if not marks or not stamps:
        return None, []
    order = sorted(range(len(stamps)), key=stamps.__getitem__)
    keys = [stamps[i] for i in order]

    def pairing(host):
        best = {}
        for m in sorted(marks):
            t = host(m)
            j = bisect.bisect_left(keys, t)
            near = min((k for k in (j - 1, j) if 0 <= k < len(keys)),
                       key=lambda k: abs(t - keys[k]))
            i, d = order[near], abs(t - keys[near])
            if d <= tol_ns and (i not in best or d < best[i][1]):
                best[i] = (m, d)
        return sorted((i, m) for i, (m, _) in best.items())

    def fit(pairs):
        pts = sorted((stamps[i], m - stamps[i]) for i, m in pairs)
        t_ref = pts[0][0]
        slopes = [(l2 - l1) / (h2 - h1) for k, (h1, l1) in enumerate(pts)
                  for h2, l2 in pts[k + 1:] if h2 > h1]
        drift = statistics.median(slopes) if slopes else 0.0
        offset = statistics.median(l - drift * (h - t_ref) for h, l in pts)
        return t_ref, offset, drift

    lags = {m - h for m in marks for h in stamps}
    first = max(sorted(lags, key=abs),
                key=lambda c: len(pairing(lambda m: m - c)))
    pairs = pairing(lambda m: m - first)
    if not pairs:
        return None, []
    for _ in range(2):
        pairs = pairing(functools.partial(to_host, fit(pairs)))
    return fit(pairs), pairs


def to_host(clock, t):
    """A profiler stamp on the host's clock, by the map of
    :func:`pair_markers`."""
    t_ref, offset, drift = clock
    return t_ref + (t - offset - t_ref) / (1.0 + drift)


def attribute(events, spans, stamps=()) -> dict:
    """The spans pass's device events (name, start ns, end ns) against
    the recorder's spans of the thread that ran the sequence, over the
    ``sequence`` span. ``stamps``: the host's ``time.time_ns()`` right
    before each marker's launch; the markers are paired with them
    (:func:`pair_markers`) and the events moved onto the recorder's clock
    by the pass's clock map before the rest.

    Returns the card's idle seconds by the innermost open span (its path,
    ``stage/sub``; idle under a stage outside every sub-stage span goes to
    the stage, idle outside every span to ``(no span)``), the busy and
    window seconds, the device seconds of ``banded.cu``'s kernels, the
    map's offset (s, at the first paired stamp) and drift (ppm), and for
    each stage whose marker was paired its marker's start less the stage
    span's start (seconds), as the trace stamps it (``marker_offsets_s``)
    and with the map taken off (``marker_offsets_aligned_s``)."""
    (root,) = [s for s in spans if s.name == "sequence"]
    mine = [s for s in spans if s.thread == root.thread]
    stamps = list(stamps)
    marks = [s for n, s, _ in events if MARKER in n]
    clock, pairs = pair_markers(marks, stamps)
    t_ref, offset, drift = clock = clock or (0, 0, 0.0)

    def host(t):       # a profiler stamp on the recorder's clock
        return round(to_host(clock, t))
    t0, t1 = root.start_ns, root.end_ns
    moved = [(n, host(s), host(e)) for n, s, e in events]
    inside = [(n, max(s, t0), min(e, t1)) for n, s, e in moved
              if e > t0 and s < t1]
    busy = _union([(s, e) for _, s, e in inside])
    pieces = _paths(mine)
    starts = [p[0] for p in pieces]
    idle = defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(pieces) and pieces[i][0] < b:
            lo, hi = max(a, pieces[i][0]), min(b, pieces[i][1])
            if hi > lo:
                idle[pieces[i][2]] += (hi - lo) / 1e9
                covered += hi - lo
            i += 1
        if b - a > covered:
            idle[OUTSIDE] += (b - a - covered) / 1e9
    banded = defaultdict(float)
    for n, s, e in inside:
        if BANDED_CU.match(n):
            banded[n.split("::", 1)[1].split("(", 1)[0]] += (e - s) / 1e9
    # a stage's marker: the first paired with a stamp taken in the stage
    stages = [s for s in mine if s.parent == root.id]
    raw, aligned = {}, {}
    for i, m in sorted(pairs, key=lambda p: stamps[p[0]]):
        for st in stages:
            if st.start_ns <= stamps[i] < st.end_ns:
                raw.setdefault(st.name, (m - st.start_ns) / 1e9)
                aligned.setdefault(st.name, (host(m) - st.start_ns) / 1e9)
    return dict(idle_by_path=dict(idle),
                busy_s=sum(e - s for s, e in busy) / 1e9,
                window_s=(t1 - t0) / 1e9,
                clock_offset_s=None if not pairs else offset / 1e9,
                clock_drift_ppm=None if not pairs else drift * 1e6,
                markers=dict(launched=len(stamps), traced=len(marks),
                             paired=len(pairs)),
                marker_lags_s=[(m - stamps[i]) / 1e9 for i, m in pairs],
                unpaired_s=[min((host(m) - h for h in stamps), key=abs) / 1e9
                            for m in sorted(set(marks) - {m for _, m in pairs})
                            if stamps],
                marker_offsets_s=raw, marker_offsets_aligned_s=aligned,
                banded_cu_s=sum(banded.values()),
                banded_by_kernel=dict(banded))


def summarize(trace, events, frames: int, peak: dict | None,
              stamps=()) -> dict:
    """What the span metrics read (``ctx["spans"]``): :func:`attribute`'s
    numbers, the recorder's walls and device times by span name, its
    counters by span name and by stage, the syncs, the pairs by kernel
    and their least time (None without the card's peaks)."""
    by_name = defaultdict(lambda: [0.0, 0.0])
    for s in trace.spans:
        by_name[s.name][0] += s.wall_s
        by_name[s.name][1] += s.device_s or 0.0
    bound, by_kernel = None, {}
    for x in trace.launches:
        k = by_kernel.setdefault(x.kernel, dict(launches=0, pairs=0))
        k["launches"] += 1
        k["pairs"] += x.pairs
        if peak is not None and "fp32_flops" in peak:
            k["bound_s"] = k.get("bound_s", 0.0) + banded_bound_s(
                x.kernel, x.pairs, x.ndim, x.n_q, x.n_d, peak)
    if peak is not None and "fp32_flops" in peak:
        bound = sum(k["bound_s"] for k in by_kernel.values())
    return dict(attribute(events, trace.spans, stamps), frames=frames,
                wall_s={k: v[0] for k, v in by_name.items()},
                device_s={k: v[1] for k, v in by_name.items() if v[1]},
                counters=trace.counters_by_span(),
                syncs_by_stage={k: v["syncs"] for k, v in
                                trace.counters_by_stage().items()
                                if "syncs" in v},
                syncs=trace.total("syncs"), banded_bound_s=bound,
                by_kernel=by_kernel)


def spans_pass(rec, cfg, clip, seq, dev) -> dict:
    """The window's first sequence under ``harness.traced_pass``'s
    profiler and stage markers (on the CPU neither: no events), with
    paired readings before it and the recorder on: the events, the
    recorder's trace, the host stamps before each marker and the wall.
    Run it before the traced pass: a profiler session right after one of
    that size loses its first records."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vilgod_tpu_torch.pipeline import runner
    from vilgod_tpu_torch.utils import trace

    from . import harness
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    zsd = runner.ZeroShotDetector(seq, "spans", cfg, clip_model=clip,
                                  device=dev)
    sync()
    rec.mode = "spans"
    stamps, raw = [], []      # host clocks right before each marker

    def marker():
        stamps.append(time.time_ns())
        raw.append(time.clock_gettime_ns(time.CLOCK_MONOTONIC_RAW))
        torch.cuda._sleep(1)
    rec.marker = marker if cuda else None
    prof = (profile(activities=[ProfilerActivity.CUDA]) if cuda
            else contextlib.nullcontext())
    with harness.hooks(rec), prof:
        for _ in range(PAIRED_READINGS if cuda else 0):
            marker()          # paired readings: on an idle card
            sync()
            time.sleep(PAIRED_GAP_NS / 1e9)
        with trace.recording(device=dev) as t:
            t0 = time.perf_counter()
            zsd.process()
            if cuda:
                rec.marker()
            sync()
            wall = time.perf_counter() - t0
    rec.mode, rec.marker = None, None
    events = [] if not cuda else [
        (e.name(), e.start_ns(), e.end_ns())
        for e in prof.profiler.kineto_results.events()
        if str(e.device_type()).endswith("CUDA")]
    return dict(events=events, trace=t, wall_s=wall,
                frames=seq.sequence_length, marker_stamps=stamps,
                marker_raw=raw)


def _log(*parts):
    print("#", *parts, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from . import cell, run, scenes
    run._caches()
    workload = cell.load(args.workload)[0]
    pending = scenes.start_sequences(workload["scene"], args.seed,
                                     workload["sequences"])
    try:
        import torch
        if not torch.cuda.is_available():
            _log("no card")
            pending.close()
            return 2
        from vilgod_tpu_torch.pipeline import runner

        from . import harness
        from . import trace as tr
        from .flops import peaks
        from .metrics import read
    except BaseException:
        pending.close()
        raise

    # the prefetch wait of each sequence the runner processes, in order:
    # the warm-up, then the window's sequences
    waits = []
    base = runner.ZeroShotDetector

    class Waiting(base):
        def process(self, spans=False):
            waits.append(self.prefetch_wait_s)
            return super().process(spans)
    runner.ZeroShotDetector = Waiting
    try:
        out = harness.run(args.workload, args.seed, args.seconds, False,
                          "cuda:0", pending=pending)
    finally:
        runner.ZeroShotDetector = base
    rec, dev = out["rec"], torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    peak = peaks(kind)
    if peak is not None and kind in FP32_FLOPS:
        peak = dict(peak, fp32_flops=FP32_FLOPS[kind])
    window = waits[1:1 + len(rec.sequences)]
    frames = sum(s["frames"] for s in rec.sequences)
    # the spans pass first: a profiler session right after one of the
    # traced pass's size loses kernel records and misplaces stamps by
    # milliseconds (PERF.md, section 7)
    sp = spans_pass(rec, out["cfg"], out["clip"], out["seqs"][0], dev)
    traced = harness.traced_pass(rec, out["cfg"], out["clip"],
                                 out["seqs"][0], dev)
    t_sum = tr.summarize(traced, out["config"]["clip"], peak)
    s_sum = summarize(sp["trace"], sp["events"], sp["frames"], peak,
                      sp["marker_stamps"])

    _log("card", run.card_line())
    _log("window", f"{out['window_s']:.3f} s, frames {frames}, prefetch "
         "waits (s)", window)
    _log("spans pass", f"{sp['wall_s']:.3f} s against the traced pass's "
         f"{traced['wall_s']:.3f} s: on-cost "
         f"{100 * (sp['wall_s'] / traced['wall_s'] - 1):.2f} %",
         "| idle", f"{s_sum['window_s'] - s_sum['busy_s']:.3f} of",
         f"{s_sum['window_s']:.3f} s (traced pass:",
         f"{t_sum['window_s'] - t_sum['busy_s']:.3f} of "
         f"{t_sum['window_s']:.3f} s)")
    off, ppm = s_sum["clock_offset_s"], s_sum["clock_drift_ppm"]
    _log("markers", json.dumps(s_sum["markers"]), "(paired readings",
         PAIRED_READINGS, "+ stages + end); the clock map's offset (us) "
         "and drift (ppm):", None if off is None else round(1e6 * off, 1),
         None if ppm is None else round(ppm, 2),
         "| each paired start less its stamp (us)",
         [round(1e6 * x, 1) for x in s_sum["marker_lags_s"]],
         "| unpaired, the map taken off, less the nearest stamp (us)",
         [round(1e6 * x, 1) for x in s_sum["unpaired_s"]])
    for key, what in (("marker_offsets_s", "as stamped"),
                      ("marker_offsets_aligned_s", "map taken off")):
        offs = s_sum[key]
        _log(f"stage marker start less stage span start (us), {what},",
             len(offs), "of", len(out["cfg"]["pipeline_active"]),
             "stages: min",
             f"{1e6 * min(offs.values()):.1f}" if offs else None, "max",
             f"{1e6 * max(offs.values()):.1f}" if offs else None,
             json.dumps({k: round(1e6 * v, 1) for k, v in offs.items()}))
    stamps, raw = sp["marker_stamps"], sp["marker_raw"]
    _log("time_ns less the raw monotonic clock at each stamp, from the "
         "first (us)", [round(((h - r) - (stamps[0] - raw[0])) / 1e3, 1)
                        for h, r in zip(stamps, raw)])
    idle = sorted(s_sum["idle_by_path"].items(), key=lambda kv: -kv[1])
    _log("idle by span (s), top ten", json.dumps(idle[:10]))
    for stage in ("mask_ground_points", "spatial_clustering",
                  "filter_detections"):
        total = sum(v for k, v in idle if k.split("/")[0] == stage)
        bare = s_sum["idle_by_path"].get(stage, 0.0)
        _log("idle in", stage, f"{total:.3f} s, on the bare stage span "
             f"{bare:.3f} s ({100 * bare / total if total else 0:.1f} %)")
    _log("syncs by stage", json.dumps(s_sum["syncs_by_stage"]), "| total",
         s_sum["syncs"])
    _log("launches, pairs and bound (s) by kernel",
         json.dumps(s_sum["by_kernel"]), "| bound", s_sum["banded_bound_s"],
         f"s against {s_sum['banded_cu_s']:.6f} s on banded.cu, by "
         "instance (s)", json.dumps(s_sum["banded_by_kernel"]))
    other = sorted({n[:160] for n, _, _ in sp["events"]
                    if tr.NEIGHBOUR_CU.match(n) and not BANDED_CU.match(n)})
    _log("neighbour kernels not in banded.cu:", json.dumps(other))
    _log("walls by span (s)", json.dumps(
        {k: round(v, 6) for k, v in sorted(s_sum["wall_s"].items())}))
    _log("device by span (s)", json.dumps(
        {k: round(v, 6) for k, v in sorted(s_sum["device_s"].items())}))
    _log("counters by span", json.dumps(s_sum["counters"], default=str))

    ctx = dict(frames=frames, prefetch_wait_s=sum(window), spans=s_sum)
    names = ["prefetch_wait_ms_per_frame", "host_syncs_per_frame",
             "ground_scan_idle_ms_per_frame", "cluster_select_ms_per_frame",
             "ransac_draw_ms_per_frame", "classify_render_ms_per_frame",
             "classify_padded_pct", "banded_roofline"]
    print(json.dumps({n: read(n, ctx) for n in names}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
