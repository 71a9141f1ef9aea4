"""The port's span recorder (``vilgod_tpu_torch.utils.trace``) on the CPU.

Off, it records nothing and opens no profiler range, CUDA event or
sync-debug mode; on, spans nest per thread with their parent, sequence id
and self time, counters go to the innermost span, the banded kernels'
pair counter equals an explicit enumeration of the scanned pairs, the
classifier counts its padded batches, and leaving a recording restores
the sync-debug mode and the warning filters, also on an exception. The
runner's stage times and its spans come from one clock pair."""
import threading
import time
import types
import warnings

import numpy as np
import pytest
import torch

from vilgod_tpu_torch.ops import kernels
from vilgod_tpu_torch.utils import trace

SMOKE_CAPS = dict(max_points=2048, max_ng_points=2048, max_clusters=16,
                  max_cluster_points=256, max_tracks=16,
                  max_cluster_input=4096, clip_batch=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_sync_mode(monkeypatch):
    """torch.cuda's sync-debug mode on a CPU build: the calls, in order."""
    calls = []
    mode = {"now": 0}

    def get():
        return mode["now"]

    def set_(m):
        calls.append(m)
        mode["now"] = m
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_)
    return calls, mode


def _tiny_detector(n_frames=2, stages=("mask_ground_points",), **kw):
    from vilgod_tpu_torch.config import waymo_config
    from vilgod_tpu_torch.data import SyntheticDataset
    from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector

    cfg = waymo_config(capacity=SMOKE_CAPS, pipeline_active=list(stages))
    ds = SyntheticDataset(n_sequences=kw.pop("n_sequences", 1),
                          n_frames=n_frames, seed=11, n_ground=900, **kw)
    return cfg, ds, ZeroShotDetector


def test_off_records_nothing_and_stage_times_stay():
    assert trace.current() is None
    assert trace.span("a") is trace.span("b", device=True) is trace._NULL
    trace.count("syncs")          # no recording: nothing to charge
    cfg, ds, zsd_cls = _tiny_detector()
    zsd = zsd_cls(ds.sequence("synth_0"), "synth_0", cfg, device="cpu")
    zsd.process()
    assert set(zsd.stage_times) == {"mask_ground_points"}
    assert zsd.stage_times["mask_ground_points"] > 0
    assert zsd.prefetch_wait_s == 0.0


def test_off_opens_no_range_event_or_sync_mode(monkeypatch):
    """With no recording, a pipeline run (ground, and a banded kernel on
    its own) touches neither the profiler, CUDA events nor the sync-debug
    mode, and counts no pairs."""
    def forbidden(*a, **k):
        raise AssertionError("opened with the recorder off")
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", forbidden)
    monkeypatch.setattr(trace.Trace, "launch", forbidden)
    cfg, ds, zsd_cls = _tiny_detector()
    zsd_cls(ds.sequence("synth_0"), "synth_0", cfg, device="cpu").process()
    q = torch.zeros((8, 8))
    kernels.banded_tile_count(q, q, torch.zeros(2, dtype=torch.int32),
                              0.1, 4, 4)


def test_nesting_parents_self_time_and_sequence():
    with trace.recording() as t:
        with trace.span("root", sequence="seq_a"):
            time.sleep(0.002)
            with trace.span("child"):
                time.sleep(0.002)
                with trace.span("grandchild"):
                    time.sleep(0.001)
            with trace.span("child2", sequence="other"):
                pass
        with trace.span("alone"):
            pass
    by = {s.name: s for s in t.spans}
    assert [s.name for s in t.spans] == ["root", "child", "grandchild",
                                         "child2", "alone"]
    assert by["root"].parent is None and by["alone"].parent is None
    assert by["child"].parent == by["root"].id
    assert by["grandchild"].parent == by["child"].id
    assert by["child2"].parent == by["root"].id
    assert by["grandchild"].sequence == by["child"].sequence == "seq_a"
    assert by["child2"].sequence == "other" and by["alone"].sequence is None
    for s in t.spans:
        assert s.start_ns <= s.end_ns
    kids = t.children()
    root, child = by["root"], by["child"]
    want = (root.end_ns - root.start_ns - (child.end_ns - child.start_ns)
            - (by["child2"].end_ns - by["child2"].start_ns)) / 1e9
    assert t.self_s(root, kids) == pytest.approx(want, abs=1e-12)
    assert t.self_s(child) == pytest.approx(
        child.wall_s - by["grandchild"].wall_s, abs=1e-12)
    assert t.self_s(by["grandchild"]) == by["grandchild"].wall_s
    assert root.wall_s >= 0.005
    assert t.stage_of(by["grandchild"]) == "child"
    assert t.stage_of(root) == "root"


def test_a_worker_thread_has_its_own_stack():
    done = threading.Event()
    with trace.recording() as t:
        with trace.span("main_outer", sequence="s0"):
            def work():
                with trace.span("worker_outer", sequence="s1"):
                    with trace.span("worker_inner"):
                        trace.count("n", 2)
                done.set()
            th = threading.Thread(target=work, name="tracer-worker")
            th.start()
            th.join(timeout=30)
            assert not th.is_alive() and done.is_set()
            with trace.span("main_inner"):
                pass
    by = {s.name: s for s in t.spans}
    assert by["worker_outer"].parent is None
    assert by["worker_outer"].thread == "tracer-worker"
    assert by["worker_inner"].parent == by["worker_outer"].id
    assert by["worker_inner"].sequence == "s1"
    assert by["main_inner"].parent == by["main_outer"].id
    assert by["main_inner"].thread == threading.current_thread().name
    assert by["worker_inner"].counters == {"n": 2}


def test_counters_go_to_the_innermost_span():
    with trace.recording() as t:
        trace.count("loose")
        with trace.span("sequence"):
            with trace.span("stage_a"):
                trace.count("syncs")
                with trace.span("sub"):
                    trace.count("syncs", 3)
                    trace.count("steps", 7)
                trace.count("syncs")
            with trace.span("stage_b"):
                trace.count("syncs", 5)
    by = {s.name: s for s in t.spans}
    assert by["stage_a"].counters == {"syncs": 2}
    assert by["sub"].counters == {"syncs": 3, "steps": 7}
    assert by["sequence"].counters == {}
    assert t.loose == {"loose": 1}
    assert t.counters_by_span() == {"stage_a": {"syncs": 2},
                                    "sub": {"syncs": 3, "steps": 7},
                                    "stage_b": {"syncs": 5}}
    assert t.counters_by_stage() == {"stage_a": {"syncs": 5, "steps": 7},
                                     "stage_b": {"syncs": 5}}
    assert t.total("syncs") == 10 and t.total("loose") == 1


def _enumerated_pairs(n_q, n_d, starts, tq, w, ends):
    """The (query, data) pairs of every block's scanned ranks, one by one:
    the start clamped into [0, n_d - w], the end at the window's or at
    ``ends[b]``, never before the start."""
    pairs = 0
    for q in range(n_q):
        b = q // tq
        s = min(max(int(starts[b]), 0), n_d - w)
        e = s + w if ends is None else max(s, min(int(ends[b]), s + w))
        for d in range(n_d):
            pairs += s <= d < e
    return pairs


CASES = {
    # block 0's start clamps up to 0, block 2's down to n_d - w; ragged
    # ends, one before its start (an empty span), one past the window
    "ragged": ([-3, 5, 14], [2, 20, 4]),
    "whole_windows": ([-3, 5, 14], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", kernels.KERNEL_NAMES)
def test_pairs_equal_an_enumeration(name, case):
    tq, w, n = 4, 8, 16
    n_q = 12 if name != "banded_tile_min_label" else n
    starts_l, ends_l = CASES[case]
    if name == "banded_tile_min_label":   # 4 blocks of the one cloud
        starts_l = starts_l + [0]
        ends_l = None if ends_l is None else ends_l + [16]
    starts = torch.tensor(starts_l, dtype=torch.int32)
    ends = None if ends_l is None else torch.tensor(ends_l, dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    q = torch.rand((8, n_q), generator=g)
    d = torch.rand((8, n), generator=g)
    with trace.recording() as t:
        with trace.span("stage"):
            if name == "banded_tile_count":
                kernels.banded_tile_count(q, d, starts, 0.1, tq, w, 3, ends)
            elif name == "banded_tile_count3":
                kernels.banded_tile_count3(q, d, starts,
                                           torch.tensor([0.01, 0.1, 0.2]),
                                           tq, w, 6, ends)
            elif name == "banded_tile_min_label":
                kernels.banded_tile_min_label(
                    d, torch.full((n,), 0.1), torch.arange(
                        n, dtype=torch.int32), starts, tq, w, 6, n, ends)
            else:
                kernels.banded_tile_nearest(q, d, starts, tq, w, 4, ends)
    want = _enumerated_pairs(n_q, n, starts_l, tq, w, ends_l)
    assert want > 0
    assert t.kernel_pairs() == {name: want}
    assert t.spans[0].counters == {f"pairs.{name}": want}
    (launch,) = t.launches
    assert (launch.n_q, launch.n_d) == (n_q, n)
    assert launch.ndim == {"banded_tile_count": 3, "banded_tile_count3": 6,
                           "banded_tile_min_label": 6,
                           "banded_tile_nearest": 4}[name]


def test_items_run_and_needed_count_the_padded_tail():
    """70 valid detections at ``clip_batch`` 64: one full batch, then the
    tail of 6 padded to the tail size 32."""
    from vilgod_tpu_torch.pipeline.stages_classify import classification

    n_frames, n_clusters = 5, 16
    valid = np.zeros((n_frames, n_clusters), bool)
    valid.reshape(-1)[:70] = True
    caps = types.SimpleNamespace(clip_batch=64, max_clusters=n_clusters,
                                 max_cluster_points=8)
    state = types.SimpleNamespace(
        caps=caps, n_frames=n_frames, torch_device=torch.device("cpu"),
        det_valid=valid, det_n=valid.astype(np.int32) * 3,
        det_cls=np.full(valid.shape, -1, np.int32),
        det_score=np.zeros(valid.shape, np.float32), done={},
        ng_bucket=lambda: 32,
        device=lambda key, f_pad, n: torch.zeros((f_pad, n, 3)),
        det_tables=lambda f_pad, n: (torch.zeros((f_pad, n_clusters, 8),
                                                 dtype=torch.int32),
                                     torch.ones((f_pad, n_clusters, 8),
                                                dtype=torch.bool)),
        transform_to_ego=lambda f: np.eye(4))
    batches = []

    class Clip:
        class_list = ["car"]
        class_mapping = {"car": "Vehicle"}

        def make_cluster_classifier(self, **kw):
            def run(ng_xyz, tables, masks, fids, cids, trs):
                batches.append(len(fids))
                b = len(fids)
                return (torch.zeros((b, 4), dtype=torch.int32),
                        torch.ones((b, 4)))
            return run

    with trace.recording() as t:
        classification(state, {}, clip_model=Clip())
    assert batches == [64, 32]
    by_span = t.counters_by_span()["classify.batch"]
    assert by_span == {"items_run": 96, "items_needed": 70}
    assert [s.name for s in t.spans] == ["classify.batch", "classify.batch",
                                         "classify.vote"]
    assert (state.det_cls[valid] == 0).all()


def test_exit_restores_sync_mode_and_filters(fake_sync_mode):
    calls, mode = fake_sync_mode
    mode["now"] = 0
    filters, show = list(warnings.filters), warnings.showwarning
    with pytest.raises(ValueError, match="inside"):
        with trace.recording(device="cuda"):
            assert mode["now"] == "warn"
            assert warnings.showwarning is not show
            raise ValueError("inside")
    assert calls == ["warn", 0] and mode["now"] == 0
    assert warnings.filters == filters and warnings.showwarning is show
    assert trace.current() is None
    with trace.recording(device="cuda"):
        pass
    assert calls == ["warn", 0, "warn", 0]
    assert warnings.filters == filters and warnings.showwarning is show


def test_sync_warnings_are_counted_to_the_innermost_span(fake_sync_mode):
    message = trace.SYNC_WARNING + " (Triggered internally at x.cpp:1.)"
    shown = []
    with warnings.catch_warnings():
        warnings.showwarning = lambda *a, **k: shown.append(str(a[0]))
        with trace.recording(device="cuda") as t:
            with trace.span("stage"):
                for _ in range(3):   # one place, every time counted
                    warnings.warn(message, UserWarning)
                with trace.span("sub"):
                    warnings.warn(message, UserWarning)
                warnings.warn("something else", UserWarning)
    assert t.counters_by_span() == {"stage": {"syncs": 3},
                                    "sub": {"syncs": 1}}
    assert shown == ["something else"]


def test_one_recording_at_a_time():
    with trace.recording():
        with pytest.raises(RuntimeError, match="already"):
            with trace.recording():
                pass
    assert trace.current() is None


def test_profiler_ranges_only_when_asked():
    from torch.profiler import ProfilerActivity, profile

    def names(ranges):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.recording(profiler_ranges=ranges):
                with trace.span("outer_range"):
                    with trace.span("inner_range", device=True):
                        torch.ones(4).sum()
        return {e.name for e in prof.events()}
    assert {"outer_range", "inner_range"} <= names(True)
    assert not {"outer_range", "inner_range"} & names(False)


def test_device_spans_on_the_cpu_read_their_wall():
    with trace.recording() as t:
        with trace.span("d", device=True):
            time.sleep(0.001)
        with trace.span("h"):
            pass
    d, h = t.spans
    assert d.device_s == d.wall_s > 0 and h.device_s is None


def test_runner_spans_and_one_clock_for_stage_times():
    """A recorded run: the sequence span, each stage under it holding the
    stage time's one ``perf_counter`` pair (the span's ``time_ns`` stamps
    are taken just outside it), and ground's sub-stage spans with the
    scan's step count (the 8-frame bucket)."""
    cfg, ds, zsd_cls = _tiny_detector()
    zsd = zsd_cls(ds.sequence("synth_0"), "synth_0", cfg, device="cpu")
    with trace.recording() as t:
        zsd.process()
    by = {s.name: s for s in t.spans}
    assert [s.name for s in t.spans] == [
        "sequence", "mask_ground_points", "ground.presort", "ground.scan",
        "ground.compact"]
    assert by["sequence"].sequence == "synth_0"
    assert all(s.sequence == "synth_0" for s in t.spans)
    stage = by["mask_ground_points"]
    assert stage.parent == by["sequence"].id
    assert abs(stage.wall_s - zsd.stage_times["mask_ground_points"]) < 1e-3
    assert by["ground.scan"].parent == stage.id
    assert by["ground.scan"].counters == {"steps": 8}
    assert t.counters_by_stage() == {"mask_ground_points": {"steps": 8}}


def test_run_sequences_records_builds_and_the_prefetch_wait():
    from vilgod_tpu_torch.pipeline import run_sequences

    cfg, ds, _ = _tiny_detector(n_sequences=2)
    with trace.recording() as t:
        run_sequences(ds, cfg, device="cpu")
    builds = [s for s in t.spans if s.name == "build"]
    assert sorted(s.sequence for s in builds) == ["synth_0", "synth_1"]
    assert {s.thread for s in builds} == {threading.current_thread().name,
                                          "vilgod-prefetch_0"}
    assert all(s.parent is None for s in builds)
    (wait,) = [s for s in t.spans if s.name == "prefetch_wait"]
    assert wait.sequence == "synth_1" and wait.parent is None
    seqs = [s.sequence for s in t.spans if s.name == "sequence"]
    assert seqs == ["synth_0", "synth_1"]


def _tower_counts(model_cfg, n_items, n_calls=1):
    """Counters of ``n_calls`` cluster-classifier calls of ``n_items``
    items each, on a tiny bf16 tower, by span."""
    from vilgod_tpu_torch.config import waymo_config
    from vilgod_tpu_torch.models.clip_wrapper import ClipWrapper

    clip = ClipWrapper(waymo_config()["preprocessor"]["clip"], device="cpu",
                       model_cfg=model_cfg)
    run = clip.make_cluster_classifier(num_clusters=4, capacity=8,
                                       resolution=16, depth=4)
    rng = np.random.default_rng(0)
    xyz = torch.from_numpy(rng.normal(size=(1, 32, 3)).astype(np.float32))
    tables = torch.arange(32, dtype=torch.int32).reshape(1, 4, 8)
    masks = torch.ones((1, 4, 8), dtype=torch.bool)
    fids = np.zeros(n_items, np.int32)
    cids = np.arange(n_items, dtype=np.int32) % 4
    trs = np.tile(np.eye(4, dtype=np.float32), (n_items, 1, 1))
    with trace.recording() as t:
        for _ in range(n_calls):
            run(xyz, tables, masks, fids, cids, trs)
    return t.counters_by_span()


@pytest.mark.parametrize("image,patch,core", [(64, 16, "onepass"),
                                              (336, 14, "long"),
                                              (378, 14, "stream")])
def test_tower_counts_its_images_and_attention_cores(image, patch, core):
    """``classify.tower`` counts the images through the tower (four views
    an item) and, on the CPU path's wrapper, one attention core a layer and
    a call, by the kind the sequence's length and head width take on the
    card: 17 tokens the one-pass core, 577 (ViT-L/14@336px's) the long one,
    730 in heads of 80 (DFN5B ViT-H/14-378's) the streaming one; and at the
    128-aligned width one ``mlp_half.fused`` a layer and a call (width 160
    is not aligned: the unfused MLP half)."""
    from vilgod_tpu_torch.models import vit_kernels
    from vilgod_tpu_torch.models.clip import CLIPConfig

    width = 160 if core == "stream" else 128       # heads of 80 or of 64
    cfg = CLIPConfig(image_size=image, patch_size=patch, vision_width=width,
                     vision_layers=2, vision_heads=2, embed_dim=32,
                     text_width=64, text_heads=1, text_layers=1,
                     dtype=torch.bfloat16)
    vit_kernels.reset_launches()
    counts = _tower_counts(cfg, n_items=3, n_calls=2)
    mlp = {} if width % 128 else {"mlp_half.fused": 2 * 2}
    assert counts["classify.tower"] == {"tower_images": 2 * 3 * 4,
                                        f"attn_core.{core}": 2 * 2, **mlp}
    assert vit_kernels.CORE_LAUNCHES == {"onepass": 0, "long": 0,
                                         "stream": 0}
