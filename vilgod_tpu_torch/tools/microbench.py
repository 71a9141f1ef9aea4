"""Times the parts of the main path's hot stages on their real inputs; the
port of the JAX package's ``tools/microbench.py``.

    python -m vilgod_tpu_torch.tools.microbench [ground entropy cluster classify]
    python -m vilgod_tpu_torch.tools.microbench --scale smoke   # the CPU

Runs the main path's scene (``tools/scenes.py``: the bench's 24-frame
parity scene at the bench's full caps; ``--scale smoke``: the bench's
smoke scene and caps on the CPU) through ground masking and entropy, so
that every part below sees the occupancies and spatial structure the
stages give it (they drive the banded kernels' cost), then times:

- ground: the batched presort of every frame against the state-threaded
  scan given that presort, and the chained scan
  (``segment_sequence_chained``) at each ``--chains`` k (k = 1 is the
  single scan);
- entropy: the whole-sequence ``entropy_sequence``;
- cluster: the selection statistics (two paged counts a group of 32
  frames) and the batched cluster-input selection of one chunk of pages
  (one ``select_keep`` launch, kernel 14), ``dbscan_labels_paged``
  whole, then its passes one
  by one: the cell sort, the 3-level count (kernel 2), one min-label round
  (kernel 3) and the propagation to convergence with the number of rounds
  it took, and the border-attach nearest pass (kernel 4); then the kNN
  label transfer (kernel 4);
- classify: ``render_cluster_views`` of ``clip_batch`` clusters against
  the ViT-B/16 bf16 image encode of their 4 x ``clip_batch`` views
  (kernel 5 in every layer).

Each part is run once untimed, then ``--reps`` times between
``torch.cuda.synchronize`` calls (the host clock); a line gives the
median ms and the launches of kernels 1-5 (and every other kernel of the
port) per call. The last line is the rows as one JSON object. It writes
no file. Runs on ``cuda`` unless ``--scale smoke``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

SECTIONS = ("ground", "entropy", "cluster", "classify")
Z_OFFSET = 1.723


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict:
    """Every kernel launch count of the port, by kernel name."""
    from ..models import vit_kernels
    from ..ops import dense_kernels, kernels, ransac_kernels, select_kernels
    return {**kernels.LAUNCHES, **dense_kernels.LAUNCHES,
            **vit_kernels.LAUNCHES, **ransac_kernels.LAUNCHES,
            **select_kernels.LAUNCHES}


def timed(label: str, fn, reps: int, device) -> dict:
    """One untimed call, then the median of ``reps`` synchronised calls;
    the row {part, ms, launches per call (non-zero only)}."""
    fn()
    sync(device)
    before = _launches()
    ts = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        ts.append(time.perf_counter() - t0)
    launches = {k: (v - before[k]) / reps for k, v in _launches().items()
                if v > before[k]}
    row = {"part": label, "ms": float(np.median(ts)) * 1e3,
           "launches": launches}
    print(f"  {label:52s} {row['ms']:10.3f} ms  " + json.dumps(launches),
          flush=True)
    return row


def build_state(scale: str, device):
    """(state, config) of the main path's scene at ``scale``, the raw
    frames on ``device``."""
    from ..pipeline.runner import ZeroShotDetector
    from .scenes import main_path

    cfg, ds = main_path(scale)
    name = ds.sequence_names()[0]
    return ZeroShotDetector(ds.sequence(name), name, cfg,
                            device=device).state, cfg


def ground_inputs(state, cfg):
    """(raw frames, mask, ground config) of the ground stage."""
    from ..ground.patchwork import ground_config_from_cfg
    from ..pipeline.stages_geometry import frame_bucket

    f_pad, n_pts = frame_bucket(state.n_frames), state.points_bucket()
    return (state.device("points", f_pad, n_pts),
            state.device("points_mask", f_pad, n_pts),
            ground_config_from_cfg(cfg, min_range=1.5))


def chained_rows(points, mask, gcfg, chains, reps: int, device) -> list:
    """The chained scan at each k over ``points`` (k = 1: the single
    scan)."""
    from ..ground.patchwork import segment_sequence_chained

    return [timed(f"ground chained scan k={k} ({points.shape[0]} frames)",
                  lambda k=k: segment_sequence_chained(points, mask, gcfg,
                                                       Z_OFFSET, k),
                  reps, device) for k in chains]


def bench_ground(state, cfg, reps: int, device, chains=(1, 3)) -> list:
    from ..ground.patchwork import _presort_frames, _scan_presorted

    print("== ground ==")
    points, mask, gcfg = ground_inputs(state, cfg)
    pts = points.clone()
    pts[..., 2] -= Z_OFFSET
    pre = _presort_frames(pts, mask, gcfg)
    rows = [timed("ground presort (batched 3-key sort, all frames)",
                  lambda: _presort_frames(pts, mask, gcfg), reps, device),
            timed("ground state scan (given presort)",
                  lambda: _scan_presorted(pts, mask, pre, gcfg, 1), reps,
                  device)]
    del pre, pts
    return rows + chained_rows(points, mask, gcfg, chains, reps, device)


def _entropy_args(state):
    from ..pipeline.stages_geometry import _frame_valid, frame_bucket

    f_pad, n_ng = frame_bucket(state.n_frames), state.ng_bucket()
    return (state.device("ng_xyz", f_pad, n_ng),
            state.device("ng_mask", f_pad, n_ng),
            _frame_valid(state.n_frames, f_pad, state.torch_device))


def bench_entropy(state, cfg, reps: int, device) -> list:
    from ..ops.entropy import entropy_sequence

    print("== entropy ==")
    args = _entropy_args(state)
    return [timed("entropy_sequence (whole sequence)",
                  lambda: entropy_sequence(
                      *args, window=min(15, state.n_frames), skip_frames=1,
                      radius=0.3, max_neighbor_points=1000), reps, device)]


def _paged_passes(feats, fmask, pages, chunk, presorted, eps, min_samples):
    """The passes of ``dbscan_labels_paged`` as the clustering runs them
    (``ops/cluster._dbscan_banded``): closures for the 3-level count, one
    min-label round, the propagation and the border-attach nearest."""
    from ..ops import cluster as cl
    from ..ops.banded import (GRID, banded_min_label, banded_nearest,
                              banded_radius_count3, block_windows,
                              page_band_width, pass_window)
    from ..ops.kernels import TQ, TQ_HEAVY, prep_t8
    from ..ops.neighbors import PAGE_ISO

    n = feats.shape[0]
    iso = (pages.to(feats.dtype) * PAGE_ISO)[:, None]
    order, cid_sorted = presorted
    points = torch.cat([feats, iso], dim=1)[order]
    mask = fmask[order]
    ndim, invalid = points.shape[1], chunk * GRID * GRID
    levels = torch.tensor(np.array([eps, eps * 2 ** 0.5, eps * 2.0],
                                   np.float32), device=feats.device)
    w_band = page_band_width(n, chunk)
    tq_l, tq_h = min(TQ, n), min(TQ_HEAVY, n)

    def window(cid_q, cid_d, tq, also=()):
        return pass_window(cid_q, cid_d, tq, w_band, invalid_cid=invalid,
                           also=also, covering_ends=False)

    pts_t8 = prep_t8(points, mask, 1)
    s_h, w_h, e_h = window(cid_sorted, cid_sorted, tq_h)

    def count3():
        return banded_radius_count3(pts_t8, pts_t8, s_h, levels * levels,
                                    tq_h, w_h, ndim=ndim, ends=e_h)[:n]

    radius, core = cl._core_radii(count3(), mask, levels, levels[2],
                                  min_samples)
    arange = torch.arange(n, dtype=torch.int32, device=feats.device)
    core_pos = torch.cumsum(core.to(torch.int32), 0, dtype=torch.int32) - 1
    core_src = torch.full((n + 1,), n, dtype=torch.int32, device=feats.device)
    core_src[torch.where(core, core_pos, n).long()] = arange
    valid_c = core_src[:n] < n
    src_cl = torch.clamp(core_src[:n], max=n - 1).long()
    cid_c = torch.where(valid_c, cid_sorted[src_cl], invalid)
    r2_c = torch.where(valid_c, (radius * radius)[src_cl], 0.0)
    core_t8 = prep_t8(points[src_cl], valid_c, 1)
    s_p, w_p, e_p = window(cid_c, cid_c, tq_h)
    labels0 = torch.where(valid_c, arange, n)
    calls = [0]

    def radius_min(labels_c):
        calls[0] += 1
        lab = torch.where(valid_c, labels_c, cl._BIG_LABEL).to(torch.int32)
        best = banded_min_label(core_t8, r2_c, lab, s_p, tq_h, w_p, ndim,
                                cl._BIG_LABEL, ends=e_p)[:n]
        return torch.where(valid_c, torch.minimum(labels_c,
                                                  torch.clamp(best, max=n)), n)

    def propagate():
        calls[0] = 0
        cl._propagate(labels0, radius_min, valid_c, n, 64)
        return calls[0] - 1        # the first min-label pass seeds round 1

    ovf_l = block_windows(cid_sorted, cid_sorted, tq_l, w_band,
                          invalid_cid=invalid)[2]
    s_n, w_n, e_n = window(cid_sorted, cid_c, tq_l, also=(ovf_l,))

    def nearest():
        return banded_nearest(pts_t8, core_t8, s_n, tq_l, w_n, ndim=ndim,
                              ends=e_n)

    return {"count3": count3, "min_label": lambda: radius_min(labels0),
            "propagate": propagate, "nearest": nearest}


class ClusterInputs(NamedTuple):
    """The clustering stage's inputs on a state's buffers: its (ng_xyz,
    ng_mask, ng_entropy, f_real) arguments, their selection statistics,
    the batched selection of the first chunk of pages (``select()``) and
    its result, the page capacity and the pages in a chunk."""
    dev_args: tuple
    stats: tuple
    select: Callable
    feats: torch.Tensor
    fmask: torch.Tensor
    cap_in: int
    chunk: int


def cluster_inputs(state, cfg) -> ClusterInputs:
    """The first chunk's cluster input as the clustering stage builds it
    (``cap_in`` and ``chunk`` by its rules; the JAX package's
    ``tools/microbench._cluster_inputs``)."""
    from ..pipeline.stages_geometry import (frame_select_stats_all,
                                            select_cluster_input)

    seed = cfg.get("random_seed", 666)
    xyz, ngm, _ = _entropy_args(state)
    ent = state.device("ng_entropy", xyz.shape[0], xyz.shape[1])
    dev_args = (xyz, ngm, ent, state.n_frames)
    n_ng = xyz.shape[1]
    cap_in = min(cfg.get("capacity", {}).get("max_cluster_input", 65536),
                 max(4096, -(-n_ng // 2048) * 2048))
    chunk = min(xyz.shape[0], 32)
    stats = frame_select_stats_all(*dev_args)

    def select():
        return select_cluster_input(*dev_args, 0, chunk, seed, stats, 2,
                                    cap_in)

    feats, fmask, _, _ = select()
    return ClusterInputs(dev_args, stats, select, feats, fmask, cap_in, chunk)


def bench_cluster(state, cfg, reps: int, device) -> list:
    from ..ops.cluster import dbscan_labels_paged, paged_cell_sort
    from ..ops.neighbors import knn_labels_paged
    from ..pipeline.stages_geometry import (frame_select_stats_all,
                                            window_origins)

    print("== cluster ==")
    model = cfg.get("preprocessor", {}).get("clustering", {}).get("model", {})
    eps = model.get("cluster_selection_epsilon", 0.15)
    min_samples = model.get("min_samples", 5)
    mcs = model.get("min_cluster_size", 15)
    dev_args, _, select, feats, fmask, cap_in, chunk = cluster_inputs(state,
                                                                       cfg)
    xyz, ngm, _, f_real = dev_args
    n_ng = xyz.shape[1]
    rows = [timed("frame_select_stats_all",
                  lambda: frame_select_stats_all(*dev_args), reps, device),
            timed(f"select_cluster_input (one chunk of {chunk} pages)",
                  select, reps, device)]
    occ = fmask.sum(dim=1).cpu().numpy()
    print(f"  pages={chunk} cap_in={cap_in} points a page: min={occ.min()} "
          f"median={int(np.median(occ))} max={occ.max()}")
    flat_feats = feats.reshape(chunk * cap_in, 5)
    flat_mask = fmask.reshape(chunk * cap_in)
    pages = torch.arange(chunk, dtype=torch.int32,
                         device=xyz.device).repeat_interleave(cap_in)
    orig = window_origins(xyz, ngm, f_real, 0, chunk, 2)

    def sort():
        return paged_cell_sort(flat_feats, flat_mask, pages, chunk,
                               origins=orig)

    presorted = sort()

    def dbscan():
        return dbscan_labels_paged(flat_feats, flat_mask, pages, chunk,
                                   eps=eps, min_samples=min_samples,
                                   min_cluster_size=mcs, presorted=presorted)

    rows.append(timed("dbscan_labels_paged (whole)", dbscan, reps, device))
    rows.append(timed("  cell sort (paged_cell_sort)", sort, reps, device))
    passes = _paged_passes(flat_feats, flat_mask, pages, chunk, presorted,
                           eps, min_samples)
    rows.append(timed("  count3 pass (kernel 2)", passes["count3"], reps,
                      device))
    rows.append(timed("  min-label pass, one round (kernel 3)",
                      passes["min_label"], reps, device))
    rounds = passes["propagate"]()
    row = timed("  propagation to convergence", passes["propagate"], reps,
                device)
    row["rounds"] = rounds
    print(f"  propagation rounds to convergence: {rounds}")
    rows.append(row)
    rows.append(timed("  nearest pass, border attach (kernel 4)",
                      passes["nearest"], reps, device))

    raw_labels, raw_probs = dbscan()
    q_pages = torch.arange(chunk, dtype=torch.int32,
                           device=xyz.device).repeat_interleave(n_ng)
    rows.append(timed(
        "knn_labels_paged (label transfer, kernel 4)",
        lambda: knn_labels_paged(
            xyz[:chunk].reshape(chunk * n_ng, 3),
            ngm[:chunk].reshape(chunk * n_ng), q_pages, flat_feats[:, :3],
            flat_mask, pages, chunk, raw_labels, raw_probs,
            dist_threshold=0.2, d_presorted=presorted, origins=orig),
        reps, device))
    return rows


def bench_classify(state, cfg, reps: int, device, model_cfg=None) -> list:
    """Rendering of ``clip_batch`` random clusters of ``max_cluster_points``
    against the tower's encode of their views (ViT-B/16 bf16 unless
    ``model_cfg``)."""
    from ..models.clip import clip_vit_b16, init_clip_params, normalize_images
    from ..ops.rasterize import render_cluster_views

    print("== classify ==")
    batch, cap = state.caps.clip_batch, state.caps.max_cluster_points
    gen = torch.Generator().manual_seed(0)
    pts = (torch.randn((batch, cap, 3), generator=gen) * 2.0).to(device)
    msk = (torch.rand((batch, cap), generator=gen) < 0.5).to(device)
    msk[:, 0] = True
    rows = [timed(f"render_cluster_views (B={batch}, P={cap})",
                  lambda: render_cluster_views(pts, msk), reps, device)]
    mcfg = model_cfg or clip_vit_b16(dtype=torch.bfloat16)
    model = init_clip_params(mcfg, seed=0, device=device)
    imgs = torch.rand((batch * 4, 224, 224, 3), generator=gen).to(device)

    def encode():
        with torch.no_grad():
            return model.encode_image(normalize_images(imgs).to(mcfg.dtype))

    rows.append(timed(f"ViT image encode (B={batch * 4}, "
                      f"{mcfg.vision_layers} layers, {mcfg.dtype})", encode,
                      reps, device))
    return rows


def run(sections, scale: str = "full", reps: int = 3, device=None,
        chains=(1, 3)) -> list:
    """The named sections on the main path's scene; returns their rows."""
    from ..pipeline.stages_geometry import (calculate_entropy_scores,
                                            mask_ground_points)
    from ..utils.common import resolve_device
    from .bench import SMOKE_CLIP

    device = resolve_device(device)
    state, cfg = build_state(scale, device)
    mask_ground_points(state, cfg)
    calculate_entropy_scores(state, cfg)
    sync(device)
    rows = []
    if "ground" in sections:
        rows += bench_ground(state, cfg, reps, device, chains)
    if "entropy" in sections:
        rows += bench_entropy(state, cfg, reps, device)
    if "cluster" in sections:
        rows += bench_cluster(state, cfg, reps, device)
    if "classify" in sections:
        from ..models.clip import CLIPConfig
        small = (None if scale == "full"
                 else CLIPConfig(**SMOKE_CLIP, dtype=torch.float32))
        rows += bench_classify(state, cfg, reps, device, small)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sections", nargs="*", choices=SECTIONS + ((),),
                    help="sections to run (default: all)")
    ap.add_argument("--scale", choices=("full", "smoke"), default="full")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--chains", default="1,3",
                    help="the chained scan's k values, comma-separated")
    args = ap.parse_args(argv)
    rows = run(set(args.sections) or set(SECTIONS), args.scale, args.reps,
               "cuda" if args.scale == "full" else "cpu",
               tuple(int(k) for k in args.chains.split(",")))
    print(json.dumps({"rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
