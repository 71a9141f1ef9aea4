"""Zero-shot pseudo-labeling over a dataset: the port's counterpart of the
JAX package's ``tools/run.py``.

A config-driven sequence loop with per-sequence result caching and a final
Waymo-protocol evaluation. The config is a preset, a YAML overlay and
dotted ``key=value`` overrides; the pipeline / pipeline_active contract is
the JAX tool's.

    python -m vilgod_tpu_torch.tools.run preprocessor=synthetic
    python -m vilgod_tpu_torch.tools.run preprocessor=synthetic device=cpu \\
        synthetic.n_frames=6 paths.results=out/results profile_dir=out/trace
    python -m vilgod_tpu_torch.tools.run config=my_overrides.yaml ...

It runs on ``cuda`` unless given ``device=cpu``. Only the synthetic
dataset is ported: the ``waymo`` and ``argoverse`` preprocessors (the
default preset is ``waymo``) raise until their adapters are (ROADMAP
queue 1 item 10). With ``profile_dir`` set, each sequence writes a
``torch.profiler`` trace there, one span per stage.
"""
from __future__ import annotations

import ast
import json
import sys
from pathlib import Path

UNPORTED_DATASETS = ("waymo", "argoverse")


def parse_overrides(argv: list[str]) -> dict:
    """``a.b.c=value`` dotted overrides; values parsed as Python literals
    where they are (lists, numbers), ``true`` / ``false`` and ``null`` /
    ``none`` in any case, else kept as strings."""
    out: dict = {}
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(f"override must be key=value: {arg}")
        key, raw = arg.split("=", 1)
        if raw.lower() in ("true", "false"):
            val = raw.lower() == "true"
        elif raw.lower() in ("null", "none"):
            val = None
        else:
            try:
                val = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                val = raw
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def build_config(overrides: dict):
    """The preset named by ``preprocessor``, then the YAML file named by
    ``config``, then the remaining overrides."""
    from ..config import argoverse_config, load_yaml, merge, waymo_config

    overrides = dict(overrides)
    preset = overrides.pop("preprocessor", None)
    if isinstance(preset, dict):
        preset = preset.get("name")
    cfg = argoverse_config() if preset == "argoverse" else waymo_config()
    if preset == "synthetic":
        cfg["preprocessor"]["name"] = "synthetic"
    yaml_path = overrides.pop("config", None)
    if yaml_path:
        cfg = merge(cfg, load_yaml(yaml_path))
    return merge(cfg, overrides)


def build_dataset(cfg):
    """The synthetic dataset of ``cfg["synthetic"]``, seeded by
    ``random_seed``; the real-data preprocessors raise."""
    name = cfg.get("preprocessor", {}).get("name", "synthetic")
    if name in UNPORTED_DATASETS:
        raise NotImplementedError(
            f"preprocessor={name}: the {name} adapter is not ported to "
            "vilgod_tpu_torch yet (ROADMAP queue 1 item 10); run "
            "preprocessor=synthetic, or the JAX package's tools/run.py")
    from ..data import SyntheticDataset
    syn = cfg.get("synthetic", {})
    return SyntheticDataset(n_sequences=syn.get("n_sequences", 1),
                            n_frames=syn.get("n_frames", 16),
                            n_ground=syn.get("n_ground", 3000),
                            n_vehicles=syn.get("n_vehicles", 2),
                            n_pedestrians=syn.get("n_pedestrians", 1),
                            n_moving=syn.get("n_moving", 1),
                            seed=cfg.get("random_seed", 666))


def build_clip_model(cfg, device, logger):
    """A ``ClipWrapper`` when ``classification`` is active: the OpenAI
    checkpoint at ``paths.clip_model`` (converted), else random weights."""
    if "classification" not in cfg.get("pipeline_active", []):
        return None
    from ..models.clip_wrapper import ClipWrapper
    paths = cfg.get("paths", {})
    clip_model = ClipWrapper(cfg["preprocessor"]["clip"],
                             checkpoint_path=paths.get("clip_model"),
                             bpe_path=paths.get("bpe_vocab"), device=device)
    if not (paths.get("clip_model") and Path(paths["clip_model"]).exists()):
        logger.warning("No CLIP checkpoint found - using random weights "
                       "(smoke mode); set paths.clip_model for real runs")
    return clip_model


def evaluate(results, dataset, cfg, logger) -> dict:
    """The Waymo-protocol APs of ``results`` against the dataset's ground
    truth, with the ``evaluate_sequence`` stage's range and flags; written
    to ``<paths.results>/ap_results.json`` where a results directory is
    set."""
    from ..eval import evaluate_detections, print_eval_log
    gt = []
    for name in dataset.sequence_names():
        seq = dataset.sequence(name)
        gt.extend(seq.get_annos(f) for f in range(seq.sequence_length))
    eval_args = next((p for p in cfg.get("pipeline", [])
                      if p["name"] == "evaluate_sequence"),
                     {}).get("args", {})
    ap = evaluate_detections(
        results, gt, class_names=tuple(cfg["preprocessor"]["class_names"]),
        eval_cfg=cfg.get("eval_cfg", {}),
        eval_range=tuple(eval_args.get("eval_range",
                                       (-50.0, -20.0, 50.0, 20.0))),
        moving=eval_args.get("moving", False),
        static=eval_args.get("static", False))
    print_eval_log(ap, logger)
    results_dir = cfg.get("paths", {}).get("results")
    if results_dir:
        out = Path(results_dir) / "ap_results.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({k: float(v) for k, v in ap.items()},
                                  indent=2))
        logger.info("AP results written to %s", out)
    return ap


def main(argv=None):
    """Run the configured pipeline over the dataset; returns the per-frame
    detection dicts."""
    from ..pipeline import run_sequences
    from ..utils import create_logger, resolve_device, set_random_seed

    argv = list(sys.argv[1:] if argv is None else argv)
    overrides = parse_overrides([a for a in argv if not a.startswith("--")])
    device = resolve_device(overrides.pop("device", None))
    cfg = build_config(overrides)
    logger = create_logger()
    set_random_seed(cfg.get("random_seed", 666))

    dataset = build_dataset(cfg)
    clip_model = build_clip_model(cfg, device, logger)
    logger.info("Pipeline on %s: %s", device,
                " -> ".join(cfg.get("pipeline_active", [])))
    paths = cfg.get("paths", {})
    results = run_sequences(dataset, cfg, clip_model=clip_model,
                            cache_dir=paths.get("sequence_data"),
                            result_dir=paths.get("results"), device=device)
    logger.info("Collected %d frames of pseudo-labels (%d detections)",
                len(results), sum(len(r["boxes_lidar"]) for r in results))
    # every dataset the port has (the synthetic one) carries ground truth
    evaluate(results, dataset, cfg, logger)
    return results


if __name__ == "__main__":
    main()
