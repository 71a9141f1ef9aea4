"""Certify the port's numpy Waymo AP against the official TF implementation;
the port of the JAX package's ``tools/certify_tf.py``.

    python -m vilgod_tpu_torch.tools.certify_tf              # numpy, then TF
    python -m vilgod_tpu_torch.tools.certify_tf --regen DIR  # a new fixture

The port's metric (``eval/detection_metrics.waymo_detection_ap``) follows
the official library's documented semantics but cannot be diffed against
it without ``waymo_open_dataset``, which is absent here: that diff waits
for an environment that has the package (``eval.waymo_tf.tf_available``).
What runs everywhere: the port's AP on the committed fixture
(``tests/fixtures/tf_cert_annos.npz``, a deterministic 6-frame scene with
all three classes, score-ranked false positives, heading errors, LEVEL_2
ground truth and misses) must equal the pinned values
(``tests/fixtures/tf_cert_expected.json``, the JAX package's) to 1e-5.
Where TF is present the script then prints numpy against TF per metric
and exits 1 beyond ``TOLERANCE``. ``--regen DIR`` writes a new fixture
and its expected AP into DIR only. The metric is host work: no device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

FIXTURE = (Path(__file__).resolve().parents[2] / "tests" / "fixtures"
           / "tf_cert_annos.npz")
EXPECTED = FIXTURE.with_name("tf_cert_expected.json")
TOLERANCE = 0.002
MATCH = 1e-5


def build_annos():
    """Deterministic det/gt anno lists exercising every metric branch
    (the JAX tool's, draw for draw)."""
    rng = np.random.default_rng(2024)
    classes = ["Vehicle", "Pedestrian", "Cyclist"]
    sizes = {"Vehicle": (4.6, 2.0, 1.7), "Pedestrian": (0.8, 0.8, 1.7),
             "Cyclist": (1.8, 0.7, 1.7)}
    det_annos, gt_annos = [], []
    for f in range(6):
        g_boxes, g_names, g_npts = [], [], []
        d_boxes, d_names, d_scores = [], [], []
        for k in range(8):
            cls = classes[(f + k) % 3]
            c = rng.uniform(-40, 40, 2)
            yaw = rng.uniform(-np.pi, np.pi)
            box = [c[0], c[1], 1.0, *sizes[cls], yaw]
            g_boxes.append(box)
            g_names.append(cls)
            g_npts.append(int(rng.integers(1, 40)))  # some L2 (<=5 pts)
            if rng.uniform() < 0.7:  # matched det with jitter + heading error
                jb = np.array(box, np.float64)
                jb[:2] += rng.normal(scale=0.15, size=2)
                jb[6] += rng.normal(scale=0.2)
                d_boxes.append(jb)
                d_names.append(cls)
                d_scores.append(float(rng.uniform(0.3, 1.0)))
        for _ in range(3):  # false positives, some above TP scores
            cls = classes[int(rng.integers(3))]
            c = rng.uniform(-60, 60, 2)
            d_boxes.append([c[0], c[1], 1.0, *sizes[cls],
                            float(rng.uniform(-np.pi, np.pi))])
            d_names.append(cls)
            d_scores.append(float(rng.uniform(0.1, 0.95)))
        gt_annos.append({"gt_boxes_lidar": np.asarray(g_boxes, np.float64),
                         "name": np.asarray(g_names),
                         "num_points_in_gt": np.asarray(g_npts)})
        det_annos.append({"boxes_lidar": np.asarray(d_boxes, np.float64),
                          "name": np.asarray(d_names),
                          "score": np.asarray(d_scores, np.float64)})
    return det_annos, gt_annos


def save_fixture(det_annos, gt_annos, path):
    """Write the annos to ``path`` (the fixture's schema)."""
    payload = {"n_frames": np.asarray(len(det_annos))}
    for i, (d, g) in enumerate(zip(det_annos, gt_annos)):
        payload[f"det_boxes_{i}"] = d["boxes_lidar"]
        payload[f"det_name_{i}"] = d["name"].astype("U16")
        payload[f"det_score_{i}"] = d["score"]
        payload[f"gt_boxes_{i}"] = g["gt_boxes_lidar"]
        payload[f"gt_name_{i}"] = g["name"].astype("U16")
        payload[f"gt_npts_{i}"] = g["num_points_in_gt"]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **payload)


def load_fixture(path=FIXTURE):
    with np.load(path) as z:
        det_annos, gt_annos = [], []
        for i in range(int(z["n_frames"])):
            det_annos.append({"boxes_lidar": z[f"det_boxes_{i}"],
                              "name": z[f"det_name_{i}"],
                              "score": z[f"det_score_{i}"]})
            gt_annos.append({"gt_boxes_lidar": z[f"gt_boxes_{i}"],
                             "name": z[f"gt_name_{i}"],
                             "num_points_in_gt": z[f"gt_npts_{i}"]})
    return det_annos, gt_annos


def numpy_drift(ap: dict, expected: dict) -> dict:
    """The metrics whose AP moved more than ``MATCH`` from the pinned
    values (a missing one counts), ``{key: (got, pinned)}``."""
    return {k: (ap.get(k), v) for k, v in expected.items()
            if k not in ap or abs(ap[k] - v) >= MATCH}


def main(argv=None) -> int:
    from ..eval import waymo_detection_ap
    from ..eval.waymo_tf import tf_available, waymo_tf_ap

    ap_ = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap_.add_argument("--regen", default=None, metavar="DIR",
                     help="write a new fixture and its expected AP to DIR")
    ap_.add_argument("--expected", default=str(EXPECTED),
                     help="the pinned AP to hold the fixture's to")
    args = ap_.parse_args(argv)

    if args.regen:
        out = Path(args.regen)
        det_annos, gt_annos = build_annos()
        save_fixture(det_annos, gt_annos, out / FIXTURE.name)
        ap = waymo_detection_ap(det_annos, gt_annos)
        (out / EXPECTED.name).write_text(json.dumps(
            {k: round(v, 6) for k, v in ap.items()}, indent=1))
        print(f"wrote {out / FIXTURE.name} and {out / EXPECTED.name}")
        return 0

    det_annos, gt_annos = load_fixture()
    ap = waymo_detection_ap(det_annos, gt_annos)
    expected = json.loads(Path(args.expected).read_text())
    drift = numpy_drift(ap, expected)
    if drift:
        print(f"numpy AP drifted from {args.expected}: {drift}")
        return 1
    print(f"numpy AP matches the {len(expected)} pinned values")
    if not tf_available():
        print("waymo_open_dataset is not available here: the numpy check "
              "is done; the TF diff runs where the package exists")
        return 0
    tf_ap = waymo_tf_ap(det_annos, gt_annos)
    worst = 0.0
    for k, v in expected.items():
        if k in tf_ap:
            d = abs(tf_ap[k] - v)
            worst = max(worst, d)
            flag = "" if d <= TOLERANCE else "   <-- DISAGREES"
            print(f"{k:48s} numpy={v:.4f} tf={tf_ap[k]:.4f} |d|={d:.4f}{flag}")
    print(f"worst |delta| = {worst:.4f} (tolerance {TOLERANCE})")
    return 0 if worst <= TOLERANCE else 1


if __name__ == "__main__":
    sys.exit(main())
