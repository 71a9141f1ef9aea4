"""Times the banded passes at several static band widths on the clustering
stage's real chunk input; the port of the JAX package's
``tools/debug_band_width.py``.

    python -m vilgod_tpu_torch.tools.debug_band_width        # the card
    python -m vilgod_tpu_torch.tools.debug_band_width --device cpu \\
        --scale smoke --widths 8192 --reps 1

The input is the first chunk of pages that the clustering stage builds on
the main path's scene after ground masking and entropy
(``microbench.cluster_inputs``; ``--scale smoke``: the bench's smoke
scene), cell-sorted by page (``paged_cell_sort``) with its page column,
as the paged DBSCAN sorts it (``prep_t8``). For each static ``w_band`` in
8192, 10240, 14336 and 20480 (cut to the full width of a smaller input)
it computes ``block_windows`` at ``TQ_HEAVY`` and ``TQ`` with their
overflow flags and times kernels 2-4 on the span of each block
(``ends``): ``banded_radius_count3`` at the DBSCAN's three core levels,
one ``banded_min_label`` round (every point a label, radius eps_cap) and
``banded_nearest``, each the median of 3 calls between
``torch.cuda.synchronize`` calls after one warm call.

Each block of the card's kernels scans only its true span, so with
``ends`` a pass's time should not move with ``w_band`` wherever no
window overflows; the outputs there must be equal across the widths
(:func:`check_widths`: counts and labels exactly, the nearest's squared
distances bit for bit on the valid query lanes). The passes take all six
columns (xyz, entropy, frame offset, page): the JAX tool passed
``ndim=5``, which drops the page column, so there a page could reach the
next page's points beyond a window's span. The first line is the card's
name and power limit (``cpu`` on the CPU). Runs on ``cuda`` unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

W_BANDS = (8192, 10240, 14336, 20480)
EPS, EPS_CAP_FACTOR = 0.15, 2.0
BIG_LABEL = 2 ** 30


def band_inputs(feats: torch.Tensor, fmask: torch.Tensor):
    """(points (8, N) in the ``prep_t8`` layout, cell ids (N,), the sorted
    mask (N,), the invalid cell id) of a chunk of pages (chunk, cap_in, 5),
    sorted as the paged DBSCAN sorts it."""
    from ..ops.banded import GRID
    from ..ops.cluster import paged_cell_sort
    from ..ops.kernels import prep_t8
    from ..ops.neighbors import PAGE_ISO

    chunk, cap_in = fmask.shape
    n = chunk * cap_in
    flat_feats, flat_mask = feats.reshape(n, 5), fmask.reshape(n)
    pages = torch.arange(chunk, dtype=torch.int32,
                         device=feats.device).repeat_interleave(cap_in)
    order, cid_sorted = paged_cell_sort(flat_feats, flat_mask, pages, chunk)
    iso = (pages.to(flat_feats.dtype) * PAGE_ISO)[:, None]
    pts = torch.cat([flat_feats, iso], dim=1)[order]
    mask = flat_mask[order]
    return prep_t8(pts, mask, 1), cid_sorted, mask, chunk * GRID * GRID


def core_levels(device) -> torch.Tensor:
    """The paged DBSCAN's three core-radius levels [eps, eps * sqrt(f),
    eps * f] (f32 from f64 arithmetic, as ``dbscan_labels_paged``)."""
    return torch.tensor(np.array([EPS, EPS * EPS_CAP_FACTOR ** 0.5,
                                  EPS * EPS_CAP_FACTOR], np.float32),
                        device=device)


def _median_ms(fn, reps: int, device) -> float:
    from .microbench import sync

    fn()
    ts = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def run(state=None, cfg=None, *, inputs=None, widths=W_BANDS, reps: int = 3,
        scale: str = "full", device=None) -> dict:
    """The passes at each width. The input is ``inputs`` = (feats, fmask)
    of one chunk, else the chunk input of ``state`` (after stages 1-2)
    and ``cfg``, else of the main path's scene at ``scale``. Returns {rows:
    a row per width (flags, times), outputs: by width (count3, min_label,
    (dist2, index)), valid: the sorted mask}."""
    from ..ops.banded import (banded_min_label, banded_nearest,
                              banded_radius_count3, block_windows,
                              full_width)
    from ..ops.kernels import TQ, TQ_HEAVY
    from ..pipeline.stages_geometry import (calculate_entropy_scores,
                                            mask_ground_points)
    from ..utils.common import resolve_device
    from . import microbench
    from .bench import device_name

    device = resolve_device(device)
    print(device_name(device), flush=True)
    if inputs is None:
        if state is None:
            state, cfg = microbench.build_state(scale, device)
            mask_ground_points(state, cfg)
            calculate_entropy_scores(state, cfg)
        chunk_input = microbench.cluster_inputs(state, cfg)
        inputs = chunk_input.feats, chunk_input.fmask
    feats, fmask = (torch.as_tensor(x).to(device) for x in inputs)
    pts_t8, cid, valid, invalid = band_inputs(feats, fmask)
    n, ndim = cid.shape[0], 6
    levels = core_levels(device)
    r2 = torch.full((n,), (EPS * EPS_CAP_FACTOR) ** 2, dtype=torch.float32,
                    device=device)
    lab = torch.arange(n, dtype=torch.int32, device=device)
    tq_h, tq_l = min(TQ_HEAVY, n), min(TQ, n)
    print(f"# points={n} valid={int(valid.sum())}", flush=True)
    rows, outputs = [], {}
    for w_band in widths:
        w = min(w_band, full_width(n))
        st_h, en_h, ovf_h = block_windows(cid, cid, tq_h, w,
                                          invalid_cid=invalid)
        st_l, en_l, ovf_l = block_windows(cid, cid, tq_l, w,
                                          invalid_cid=invalid)
        row = {"w_band": w_band, "w": w, "ovf_h": bool(ovf_h),
               "ovf_l": bool(ovf_l)}
        print(f"w_band={w_band} ovf_h={row['ovf_h']} ovf_l={row['ovf_l']}",
              flush=True)
        passes = {
            "count3": lambda: banded_radius_count3(
                pts_t8, pts_t8, st_h, levels * levels, tq_h, w, ndim=ndim,
                ends=en_h),
            "min_label": lambda: banded_min_label(
                pts_t8, r2, lab, st_h, tq_h, w, ndim, BIG_LABEL, ends=en_h),
            "nearest": lambda: banded_nearest(pts_t8, pts_t8, st_l, tq_l, w,
                                              ndim=ndim, ends=en_l)}
        for label, fn in passes.items():
            row[f"{label}_ms"] = _median_ms(fn, reps, device)
            print(f"  {label:28s} {row[f'{label}_ms']:7.1f} ms", flush=True)
        outputs[w_band] = tuple(fn() for fn in passes.values())
        rows.append(row)
    return {"rows": rows, "outputs": outputs, "valid": valid}


def check_widths(result: dict) -> list[int]:
    """Holds the outputs of every width whose windows do not overflow to
    the first such width's: counts and labels equal on every lane, the
    nearest's indices equal and squared distances bitwise equal on the
    valid query lanes. Returns the widths compared (AssertionError on a
    difference)."""
    ok = [r["w_band"] for r in result["rows"]
          if not (r["ovf_h"] or r["ovf_l"])]
    valid = result["valid"]
    for w in ok[1:]:
        (c_a, l_a, (d_a, i_a)), (c_b, l_b, (d_b, i_b)) = (
            result["outputs"][ok[0]], result["outputs"][w])
        for name, a, b in (("count3", c_a, c_b), ("min_label", l_a, l_b),
                           ("nearest index", i_a[valid], i_b[valid]),
                           ("nearest dist2",
                            d_a[valid].view(torch.int32),
                            d_b[valid].view(torch.int32))):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{name} at w_band {w} differs from w_band {ok[0]} on "
                    f"{int((a != b).sum())} values")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", choices=("full", "smoke"), default="full")
    ap.add_argument("--widths", default=",".join(map(str, W_BANDS)),
                    help="static band widths, comma-separated")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    result = run(widths=tuple(int(w) for w in args.widths.split(",")),
                 reps=args.reps, scale=args.scale, device=args.device)
    print(f"# equal across the widths without overflow: "
          f"{check_widths(result)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
