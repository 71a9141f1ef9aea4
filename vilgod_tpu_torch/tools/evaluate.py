"""Re-score saved pseudo-labels against a dataset's ground truth: the
port's counterpart of the JAX package's ``tools/evaluate.py``, with the
same flags.

It reads the run tool's per-sequence result ``.npz`` files (the
``results`` key; either package's runner writes this schema) from a
directory, or one pickle of frame dicts, and scores them with the
Waymo-protocol AP against the Waymo or Argoverse split at ``--data``.
Numpy only: nothing runs on the card.

    python -m vilgod_tpu_torch.tools.evaluate --results out/results \\
        --data /data/waymo [--dataset waymo|argoverse] [--split val] \\
        [--moving|--static] [--eval-range -50 -20 50 20] [--iou 0.4] \\
        [--cluster-eval]
"""
from __future__ import annotations

import argparse
import pickle
import sys
from pathlib import Path

import numpy as np


def load_results(path: Path) -> dict[str, list[dict]]:
    """Per-sequence frame dicts from runner .npz files or one pickle."""
    out = {}
    if path.is_dir():
        for f in sorted(path.glob("*.npz")):
            with np.load(f, allow_pickle=True) as d:
                out[f.stem] = list(d["results"])
    else:
        with open(path, "rb") as fp:
            data = pickle.load(fp)
        out[path.stem] = list(data)
    return out


def main(argv=None) -> dict:
    """Parse the flags, score, print the AP table; returns the AP dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--dataset", default="waymo",
                    choices=["waymo", "argoverse"])
    ap.add_argument("--split", default="val")
    ap.add_argument("--moving", action="store_true")
    ap.add_argument("--static", action="store_true")
    ap.add_argument("--bev", action="store_true")
    ap.add_argument("--class-agnostic", action="store_true")
    ap.add_argument("--score-thresh", type=float, default=0.0)
    ap.add_argument("--eval-range", type=float, nargs=4,
                    default=[-50.0, -20.0, 50.0, 20.0])
    ap.add_argument("--iou", type=float, default=0.4)
    ap.add_argument("--cluster-eval", action="store_true",
                    help="also print per-sequence cluster recall/precision "
                         "and moving-flag accuracy aggregates")
    args = ap.parse_args(argv)

    from ..data import ArgoverseSequenceDataset, WaymoSequenceDataset
    from ..eval import (evaluate_detections, evaluate_sequence_quality,
                        print_eval_log)

    dataset_cls = (WaymoSequenceDataset if args.dataset == "waymo"
                   else ArgoverseSequenceDataset)
    ds = dataset_cls(args.data, split=args.split)

    results = load_results(Path(args.results))
    det_annos, gt_annos = [], []
    for name in ds.sequence_names():
        if name not in results:
            continue
        seq = ds.sequence(name)
        frames = results[name]
        if len(frames) != seq.sequence_length:
            print(f"warning: {name}: {len(frames)} result frames vs "
                  f"{seq.sequence_length} GT frames", file=sys.stderr)
        n = min(len(frames), seq.sequence_length)
        seq_gt = [seq.get_annos(f) for f in range(n)]
        det_annos.extend(frames[:n])
        gt_annos.extend(seq_gt)
        if args.cluster_eval:
            ev = evaluate_sequence_quality(frames[:n], seq_gt)
            cr = ev.cluster_filtered_tracked_results_mean()
            print(f"{name}: box_recall={cr.box_recall:.3f} "
                  f"box_precision={cr.box_precision:.3f} "
                  f"point_recall={cr.point_recall:.3f} "
                  f"moving P={ev.cluster_moving_precision_mean():.3f} "
                  f"R={ev.cluster_moving_recall_mean():.3f} "
                  f"(tp={ev.cluster_moving_tp()} fp={ev.cluster_moving_fp()} "
                  f"fn={ev.cluster_moving_fn()})")
    if not det_annos:
        raise SystemExit("no overlapping sequences between results and dataset")

    ap_dict = evaluate_detections(
        det_annos, gt_annos, class_names=tuple(ds.class_names),
        eval_cfg={"iou_thresholds": (args.iou,) * 4, "difficulties": (2,)},
        eval_range=tuple(args.eval_range), score_thresh=args.score_thresh,
        bev=args.bev, class_agnostic=args.class_agnostic,
        moving=args.moving, static=args.static)
    print_eval_log(ap_dict)
    return ap_dict


if __name__ == "__main__":
    main()
