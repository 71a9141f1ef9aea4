"""Holds the port's ground segmentation to the C++ Patchwork++ oracle
(``ground/native``) on the four cases of the JAX package's
``tests/test_ground_native.py``.

    python -m vilgod_tpu_torch.tools.ground_oracle            # the card
    python -m vilgod_tpu_torch.tools.ground_oracle --device cpu

The oracle runs on the host; ``segment_ground`` runs on the device. The
cases, drawn in order from one ``default_rng(666)``:

- flat: the oracle on a flat scene with four boxes: ground recall > 0.9,
  false positives < 0.15;
- parity: the oracle and ``segment_ground`` (fresh states) on a new
  scene padded to 16384 points: ground IoU > 0.97;
- adapts: the oracle over three scenes: its sensor height within 0.2 m of
  1.723;
- sequence: the oracle and ``segment_ground`` with its state threaded
  through six frames of a synthetic sequence (seed 7): agreement > 0.999
  on every frame.

It prints the card's name and power limit, then one JSON line of what the
cases measured; a case out of bounds raises.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

SENSOR_HEIGHT = 1.723


def flat_scene(rng, n_ground: int = 12000,
               sensor_height: float = SENSOR_HEIGHT):
    """Flat ground at z = -sensor_height and four boxes sticking up:
    (points (N, 4) [x, y, z, intensity] f32, ground labels (N,)); the
    JAX package's ``tests/test_ground.make_scene``."""
    r = np.sqrt(rng.uniform(2.0 ** 2, 30.0 ** 2, size=n_ground))
    th = rng.uniform(0, 2 * np.pi, size=n_ground)
    gz = -sensor_height + rng.normal(scale=0.02, size=n_ground)
    ground = np.column_stack([r * np.cos(th), r * np.sin(th),
                              gz]).astype(np.float32)
    objs = []
    for cx, cy in [(8, 0), (-10, 5), (5, -12), (15, 14)]:
        n = 400
        objs.append(np.column_stack([
            rng.uniform(cx - 1, cx + 1, n), rng.uniform(cy - 1, cy + 1, n),
            rng.uniform(-sensor_height + 0.3, -sensor_height + 2.0, n)]))
    pts = np.concatenate([ground, np.concatenate(objs).astype(np.float32)])
    intensity = np.full((len(pts), 1), 0.5, np.float32)
    labels = np.concatenate([np.ones(len(ground), bool),
                             np.zeros(4 * 400, bool)])
    perm = rng.permutation(len(pts))
    return np.hstack([pts, intensity])[perm].astype(np.float32), labels[perm]


def _segment(pts, total, state, cfg, device):
    """``segment_ground`` of ``pts`` padded to ``total`` points on
    ``device``: (mask of the real points (numpy), state)."""
    from ..ground import segment_ground

    padded = np.zeros((total, pts.shape[1]), np.float32)
    padded[:len(pts)] = pts
    mask = np.zeros(total, bool)
    mask[:len(pts)] = True
    g, state, _ = segment_ground(torch.from_numpy(padded).to(device),
                                 torch.from_numpy(mask).to(device), state,
                                 cfg)
    return g.cpu().numpy()[:len(pts)], state


def sequence_frames():
    """The six frames of the sequence case, z moved by the sensor height."""
    from ..data import SyntheticDataset

    seq = SyntheticDataset(n_sequences=1, seed=7, n_frames=6, n_ground=8000,
                           n_vehicles=3, n_pedestrians=1, n_moving=1,
                           area=50.0).sequence("synth_0")
    frames = []
    for f in range(6):
        pts = seq.get_lidar_points(f).astype(np.float32)
        pts[:, 2] -= SENSOR_HEIGHT
        frames.append(pts)
    return frames


def run(device=None) -> dict:
    """The four cases; returns what they measured (AssertionError on a
    bound)."""
    from ..ground import GroundConfig, init_ground_state
    from ..ground.native import NativePatchwork
    from ..utils.common import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(666)
    cfg = GroundConfig(patch_capacity=512)

    pts, labels = flat_scene(rng)
    g = NativePatchwork(cfg).segment(pts)
    recall = float((g & labels).sum() / labels.sum())
    fp = float((g & ~labels).sum() / max((~labels).sum(), 1))

    pts, _ = flat_scene(rng)
    g_nat = NativePatchwork(cfg).segment(pts)
    g_dev, _ = _segment(pts, 16384, init_ground_state(cfg, device), cfg,
                        device)
    iou = float((g_nat & g_dev).sum() / max((g_nat | g_dev).sum(), 1))

    native = NativePatchwork(cfg)
    for _ in range(3):
        native.segment(flat_scene(rng, n_ground=8000)[0])
    height = native.sensor_height

    seq_cfg = GroundConfig(patch_capacity=512, min_range=1.5)
    native = NativePatchwork(seq_cfg)
    state = init_ground_state(seq_cfg, device)
    agreement = []
    for pts in sequence_frames():
        g_dev, state = _segment(pts, 32768, state, seq_cfg, device)
        agreement.append(float((g_dev == native.segment(pts)).mean()))
    out = {"recall": recall, "false_positive": fp, "iou": iou,
           "sensor_height": height, "agreement": agreement}
    if not (recall > 0.9 and fp < 0.15 and iou > 0.97
            and abs(height - SENSOR_HEIGHT) < 0.2
            and min(agreement) > 0.999):
        raise AssertionError(f"ground against the native oracle out of "
                             f"bounds: {out}")
    return out


def main(argv=None) -> int:
    from ..utils.common import resolve_device
    from .bench import device_name

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    print(device_name(resolve_device(args.device)), flush=True)
    print(json.dumps(run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
