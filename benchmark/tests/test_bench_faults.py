"""A run of the harness on the CPU (no look for a card) with the timed
path broken underneath reads ``correct`` false: a stage that leaves its
state unchanged (ground, filter, classification), a stage's answers
altered where they are produced (every point or no point ground, half of
the clusters left out, every detection dropped, a view's score, a
point's entropy), half of the classifier's batch left out. The cell runs
on one card, so there is no exchange between cards to leave out."""
import numpy as np
import torch

from benchmark import check, harness


def _correct(tiny_root) -> tuple[bool, dict]:
    torch.set_num_threads(4)
    out = harness.run("tiny", 77, 0.0, False, "cpu", workers=2,
                      root=tiny_root)
    values = check.readings(out["rec"].sequences, out["seqs"], out["config"],
                            77, torch.device("cpu"))
    return check.judge(values, out["limits"])


def _over(table, name) -> bool:
    return not np.isfinite(table[name]["value"]) or \
        table[name]["value"] > table[name]["limit"]


def _stage(name):
    from vilgod_tpu_torch.pipeline import runner
    return runner.STAGE_REGISTRY, name, runner.STAGE_REGISTRY[name]


def test_classification_leaves_its_state_unchanged(tiny_root, monkeypatch):
    reg, name, _ = _stage("classification")
    monkeypatch.setitem(reg, name, lambda state, cfg, **kw: None)
    ok, table = _correct(tiny_root)
    assert not ok and table["cls_missing"]["value"] > 0


def test_half_of_the_batch_left_out(tiny_root, monkeypatch):
    reg, name, orig = _stage("classification")

    def half(state, cfg, **kw):
        keep = state.det_valid.copy()
        flat = state.det_valid.reshape(-1)
        flat[np.flatnonzero(flat)[1::2]] = False
        try:
            return orig(state, cfg, **kw)
        finally:
            state.det_valid[:] = keep
    monkeypatch.setitem(reg, name, half)
    ok, table = _correct(tiny_root)
    assert not ok and table["cls_missing"]["value"] > 0


def test_a_score_altered_where_produced(tiny_root, monkeypatch):
    from vilgod_tpu_torch.models.clip_wrapper import ClipWrapper
    make = ClipWrapper.make_cluster_classifier

    def altered(self, **kw):
        run = make(self, **kw)

        def wrong(*args):
            idx, score = run(*args)
            score = score.clone()
            score[:, 0] += 0.5
            return idx, score
        return wrong
    monkeypatch.setattr(ClipWrapper, "make_cluster_classifier", altered)
    ok, table = _correct(tiny_root)
    assert not ok and _over(table, "cls_logprob_err")


def test_an_entropy_altered_where_produced(tiny_root, monkeypatch):
    from vilgod_tpu_torch.pipeline.stages_geometry import frame_bucket
    reg, name, orig = _stage("calculate_entropy_scores")

    def altered(state, cfg, **kw):
        orig(state, cfg, **kw)
        scores = state.device("ng_entropy", frame_bucket(state.n_frames),
                              state.ng_bucket())
        scores[:, 0] += 0.25
    monkeypatch.setitem(reg, name, altered)
    ok, table = _correct(tiny_root)
    assert not ok and _over(table, "entropy_err")


def _after(monkeypatch, name, fault):
    reg, name, orig = _stage(name)

    def broken(state, cfg, **kw):
        out = orig(state, cfg, **kw)
        fault(state)
        return out
    monkeypatch.setitem(reg, name, broken)


def _ground_set(value):
    from vilgod_tpu_torch.pipeline.stages_geometry import (frame_bucket,
                                                           rebuild_ng_buffers)

    def fault(state):
        mask = state.device("points_mask", frame_bucket(state.n_frames),
                            state.points_bucket())
        ground = state.device("ground_mask", frame_bucket(state.n_frames),
                              state.points_bucket())
        ground.copy_(mask if value else torch.zeros_like(mask))
        rebuild_ng_buffers(state)
    return fault


def test_ground_marks_no_point(tiny_root, monkeypatch):
    _after(monkeypatch, "mask_ground_points", _ground_set(False))
    ok, table = _correct(tiny_root)
    assert not ok and _over(table, "ground_kept_share")


def test_ground_marks_every_point(tiny_root, monkeypatch):
    _after(monkeypatch, "mask_ground_points", _ground_set(True))
    ok, table = _correct(tiny_root)
    assert not ok and _over(table, "object_ground_share")


def test_half_of_the_clusters_left_out(tiny_root, monkeypatch):
    from vilgod_tpu_torch.pipeline.stages_geometry import frame_bucket

    def fault(state):
        labels = state.device("labels", frame_bucket(state.n_frames),
                              state.ng_bucket())
        labels.masked_fill_(labels % 2 == 1, -1)
    _after(monkeypatch, "spatial_clustering", fault)
    ok, table = _correct(tiny_root)
    assert not ok and _over(table, "cluster_mismatch_share")


def test_filter_leaves_its_state_unchanged(tiny_root, monkeypatch):
    reg, name, _ = _stage("filter_detections")
    monkeypatch.setitem(reg, name, lambda state, cfg, **kw: None)
    ok, table = _correct(tiny_root)
    assert not ok and _over(table, "plane_err_m")


def test_filter_drops_every_detection(tiny_root, monkeypatch):
    def fault(state):
        state.det_valid[...] = False
    _after(monkeypatch, "filter_detections", fault)
    ok, table = _correct(tiny_root)
    assert not ok and _over(table, "filter_mismatch")


def test_no_fault_reads_correct(tiny_root):
    ok, table = _correct(tiny_root)
    assert ok, table
