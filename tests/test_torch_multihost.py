"""Multi-process sequence striding of the port's ``run_sequences``
(tests/test_multihost.py's counterparts).

``run_sequences`` takes ``names[rank::world]`` when the caller has
initialised a ``torch.distributed`` process group: sequences are
independent, so processes never communicate; results land in the shared
result directory and any process re-scores the union. An off-by-one there
silently drops sequences in a real run, so processes are simulated by
monkeypatching ``torch.distributed``'s rank and world size, and one real
two-process ``gloo`` group runs on the CPU. The stage list is host-only:
the striding under test is pure Python.
"""
import json
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vilgod_tpu_torch.config import waymo_config
from vilgod_tpu_torch.data import SyntheticDataset
from vilgod_tpu_torch.pipeline import run_sequences
from vilgod_tpu_torch.pipeline.runner import process_grid

CAPS = {"max_points": 1024, "max_ng_points": 512, "max_clusters": 8,
        "max_cluster_points": 128, "max_tracks": 8, "max_cluster_input": 512,
        "clip_batch": 2}


def _dataset(n_seqs=5):
    return SyntheticDataset(n_sequences=n_seqs, n_frames=2, seed=21,
                            n_ground=150, n_vehicles=1, n_pedestrians=0,
                            n_moving=0)


def _cfg():
    return waymo_config(capacity=CAPS, pipeline_active=["evaluate_sequence"])


def _as_process(monkeypatch, rank, world):
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda: world)


def test_no_process_group_is_one_process():
    assert not dist.is_initialized()
    assert process_grid() == (0, 1)


@pytest.mark.parametrize("world", [2, 3, 8])
def test_every_sequence_processed_exactly_once(tmp_path, monkeypatch, world):
    ds = _dataset(5)
    result_dir = tmp_path / "results"
    processed_by: dict[str, list[int]] = {}
    for rank in range(world):
        _as_process(monkeypatch, rank, world)
        before = {p.stem for p in result_dir.glob("*.npz")}
        run_sequences(ds, _cfg(), result_dir=result_dir, prefetch_next=False,
                      device="cpu")
        for name in {p.stem for p in result_dir.glob("*.npz")} - before:
            processed_by.setdefault(name, []).append(rank)
    names = list(ds.sequence_names())
    assert set(processed_by) == set(names), (
        f"dropped: {set(names) - set(processed_by)}")
    for name, ranks in processed_by.items():
        assert ranks == [names.index(name) % world], (name, ranks)


def test_union_rescore_from_shared_results(tmp_path, monkeypatch):
    """After a 3-process run, one process over the shared result directory
    reads every sequence from it (none reprocessed) and gets the union in
    dataset order."""
    ds = _dataset(4)
    result_dir = tmp_path / "results"
    for rank in range(3):
        _as_process(monkeypatch, rank, 3)
        run_sequences(ds, _cfg(), result_dir=result_dir, prefetch_next=False,
                      device="cpu")
    monkeypatch.undo()

    class NoBuild(SyntheticDataset):
        def sequence(self, name):  # pragma: no cover - must not be called
            raise AssertionError(f"{name} was reprocessed instead of cached")

    nb = NoBuild.__new__(NoBuild)
    nb.__dict__.update(ds.__dict__)
    union = run_sequences(nb, _cfg(), result_dir=result_dir,
                          prefetch_next=False, device="cpu")
    assert len(union) == sum(ds.sequence(n).sequence_length
                             for n in ds.sequence_names())
    for r in union:
        assert set(r) == {"boxes_lidar", "name", "score", "moving"}
    # with shard_hosts off every process takes every sequence
    _as_process(monkeypatch, 1, 3)
    assert len(run_sequences(nb, _cfg(), result_dir=result_dir,
                             shard_hosts=False, prefetch_next=False,
                             device="cpu")) == len(union)


def _gloo_worker(rank, world, store, result_dir, out_dir):
    """One process of a real ``gloo`` group: runs the sequences and
    records which of them this process built."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        built = []

        class Recording(SyntheticDataset):
            def sequence(self, name):
                built.append(name)
                return super().sequence(name)

        ds = _dataset(5)
        rec = Recording.__new__(Recording)
        rec.__dict__.update(ds.__dict__)
        results = run_sequences(rec, _cfg(), result_dir=result_dir,
                                prefetch_next=False, device="cpu")
        Path(out_dir, f"{rank}.json").write_text(json.dumps(
            {"grid": process_grid(), "built": built,
             "frames": len(results)}))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def test_two_gloo_processes_split_the_sequences(tmp_path):
    world = 2
    out = tmp_path / "out"
    out.mkdir()
    ctx = mp.spawn(_gloo_worker, args=(world, tmp_path / "store",
                                       tmp_path / "results", out),
                   nprocs=world, join=False)
    for _ in range(240):
        if ctx.join(timeout=1):
            break
    else:
        for p in ctx.processes:
            p.kill()
        pytest.fail("the gloo processes did not finish within 240 s")
    assert all(not p.is_alive() for p in ctx.processes)
    names = list(_dataset(5).sequence_names())
    reports = [json.loads((out / f"{r}.json").read_text())
               for r in range(world)]
    for rank, rep in enumerate(reports):
        assert rep["grid"] == [rank, world]
        assert rep["built"] == names[rank::world]
        assert rep["frames"] == 2 * len(names[rank::world])
    assert sorted(p.stem for p in (tmp_path / "results").glob("*.npz")) == \
        sorted(names)
