"""The numbers that decide ``correct``: the program's outputs of the
window's sequences against the plain reference (``reference/``), on
frames and detections sampled from the seed.

Each stage is checked on inputs the reference makes itself, except where
it follows the program one stage on: the non-ground cloud is cut by the
program's ground masks (which the scene's own ground labels check), and
the filter and the classifier take the program's cluster labels (which
the clustering reference checks on frames of its own). With ``control``
the control (the reference in the precision below the configuration's:
TF32 products for the float32 geometry, an fp8 tower for the bfloat16
one; ``"operands"``: fp8 products alone) takes the program's place.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import clip as ref_clip
from .reference import cluster as ref_cluster
from .reference import filter as ref_filter
from .reference import geometry, render
from .reference.precision import tf32
from .weights import make_weights

NUM_VIEWS = len(render.VIEW_ANGLES)
# a filter verdict counts where every threshold lies farther than this
# from the reference's metric (m): float32 rounding moves them by ~1e-5
FILTER_MARGIN = 1e-3
# the plane's error is read over this range (m), the ground stage's reach
PLANE_RANGE = 80.0
# object points at least this high (m) are never ground
OBJECT_MIN_Z = 0.3


def _vote(names: list[str], scores: np.ndarray) -> tuple[str, float]:
    """The views' majority class, a tie going to the highest mean score
    among all the views' classes; the mean score of the winner's views."""
    uniq, counts = np.unique(names, return_counts=True)
    arr = np.asarray(names)
    if np.sum(counts[np.argmax(counts)] == counts) > 1:
        best, best_score = None, 0.0
        for name in uniq:
            s = float(np.mean(scores[arr == name]))
            if s > best_score:
                best, best_score = name, s
        return best, best_score
    name = uniq[np.argmax(counts)]
    return name, float(np.mean(scores[arr == name]))


def _worst(out: dict, name: str, value) -> None:
    """Raise ``out[name]`` to ``value``; a NaN reads as infinite."""
    value = float(value)
    out[name] = max(out[name], value if value == value else float("inf"))


def _ground(seq, source, r, f, q, out):
    """The program's ground mask of frame ``f`` against the scene's own
    labels: its first ``ground_counts[f]`` points are the ground."""
    g = seq["ground"][r, :len(q)]
    truth = np.arange(len(q)) < source.ground_counts[f]
    z = q @ source.poses[f][2, :3] + source.poses[f][2, 3]
    high = ~truth & (z >= OBJECT_MIN_Z)
    out["_ground"] += truth.sum()
    out["_ground_kept"] += (truth & ~g).sum()
    out["_high"] += high.sum()
    out["_high_ground"] += (high & g).sum()


def _geometry(seq, source, config, device, control, out, info):
    cap_ng = config["capacity"]["max_ng_points"]
    max_points = config["capacity"]["max_points"]
    ent = config["entropy"]
    clu = config["clustering"]
    n_f = len(source.frames)
    world, raw = {}, {}
    for r, f in enumerate(seq["rows"]):
        q = geometry.quantized(source.frames[f], max_points)
        _ground(seq, source, r, f, q, out)
        src = np.flatnonzero(~seq["ground"][r, :len(q)])[:cap_ng]
        prog_src = seq["ng_src"][r][seq["ng_mask"][r]]
        m = min(len(src), len(prog_src))
        out["ng_index_mismatch"] += (abs(len(src) - len(prog_src))
                                     + int(np.sum(src[:m] != prog_src[:m])))
        ref = geometry.to_first_pose(q[src], source.poses, f)
        prog = seq["ng_xyz"][r][:len(prog_src)].astype(np.float64)
        if control:
            prog = geometry.to_first_pose_control(q[src], source.poses, f,
                                                  device)
        if m:
            _worst(out, "ng_xyz_err_m", np.abs(prog[:m] - ref[:m]).max())
        world[f] = torch.from_numpy(ref).float().to(device)
        raw[f] = (q, src)

    scores = {}
    for i, f in enumerate(seq["entropy_frames"]):
        frames, own = geometry.window_frames(
            f, n_f, ent["n_neighbouring_frames"], ent["skip_frames"])
        args = (world[f], [world[w] for w in frames], own,
                ent["max_neighbor_point_dist"], ent["max_neighbor_points"])
        scores[f] = geometry.entropy(*args)
        ref = scores[f].cpu().numpy()
        prog = (geometry.entropy(*args, control=True).cpu().numpy()
                if control else seq["entropy"][i][:len(ref)])
        if len(prog) == len(ref) and len(ref):
            _worst(out, "entropy_err", np.abs(prog - ref).max())
        elif len(ref):
            out["entropy_err"] = float("inf")

    n_ng = seq["ng_bucket"]
    cap_in = min(config["capacity"]["max_cluster_input"],
                 max(4096, -(-n_ng // 2048) * 2048))
    for f in seq["cluster_frames"]:
        win = geometry.cluster_window(f, n_f, clu["n_frames"])

        def partition(ctl):
            feats, src_rel, src_row, wanted = ref_cluster.select(
                [world[w] for w in win], [scores[w] for w in win], f,
                list(range(len(win))), seed=config["random_seed"],
                n_rows=n_ng, cap_in=cap_in, control=ctl)
            info["cluster_input_max"] = max(info.get("cluster_input_max", 0),
                                            wanted)
            info["cluster_input_cap"] = cap_in
            labels, probs = ref_cluster.dbscan(
                feats, clu["eps"], clu["min_samples"],
                clu["min_cluster_size"], control=ctl)
            return ref_cluster.frame_labels(
                world[f], feats, src_rel, src_row, win.index(f), labels,
                probs, clu["prob_threshold"], control=ctl).cpu().numpy()
        ref = partition(False)
        prog = partition(True) if control else seq["labels"][f][:len(ref)]
        _worst(out, "cluster_mismatch_share",
               ref_cluster.mismatch_share(prog, ref))

    flt = config["filter"]
    n_pts = seq["points_bucket"]
    for i, f in enumerate(seq["filter_frames"]):
        q, src = raw[f]
        t = np.linalg.inv(source.poses[0]) @ source.poses[f]
        g = seq["ground"][seq["rows"].index(f), :len(q)]
        gmask = torch.zeros(n_pts, dtype=torch.bool, device=device)
        gmask[:len(q)] = torch.from_numpy(g if g.sum() >= 3
                                          else np.ones(len(q), bool))
        planes = {}
        for ctl in {False, bool(control)}:
            pts = torch.zeros(n_pts, 3, dtype=torch.float32, device=device)
            pts[:len(q)] = ref_filter.to_first_pose(q, t, device, ctl)
            planes[ctl] = ref_filter.ground_plane(
                pts, gmask, config["random_seed"], f, flt["ransac_iters"],
                control=ctl)
        ref_plane = planes[False]
        prog_plane = (planes[True] if control else torch.from_numpy(
            seq["plane"][i]).to(device))
        _worst(out, "plane_err_m",
               PLANE_RANGE * (prog_plane[:3] - ref_plane[:3]).norm()
               + (prog_plane[3] - ref_plane[3]).abs())
        labels = torch.from_numpy(seq["labels"][f][:len(src)]).to(device)
        c = config["capacity"]["max_clusters"]
        xyz = ref_filter.to_first_pose(q[src], t, device)
        m = ref_filter.cluster_metrics(xyz, labels, ref_plane, c)
        valid, decided = ref_filter.verdicts(m, flt["filters"],
                                             FILTER_MARGIN)
        if control:
            xyz_c = ref_filter.to_first_pose(q[src], t, device, True)
            m_c = ref_filter.cluster_metrics(xyz_c, labels, prog_plane, c,
                                             control=True)
            prog_valid, _ = ref_filter.verdicts(m_c, flt["filters"], 0.0)
            prog_n = m_c["n"]
        else:
            prog_valid = seq["valid_filter"][f]
            prog_n = seq["det_n"][f]
        out["filter_mismatch"] += int(np.sum((prog_valid != valid) & decided)
                                      + np.sum(prog_n != m["n"]))
        info["filter_valid"] = info.get("filter_valid", 0) + int(valid.sum())


def _classification(seq, source, config, w, text, text_c, device, control,
                    out, errs):
    tower, proj = config["clip"], config["projection"]
    prompts = config["prompts"]
    names = [prompts["class_mapping"][c] for c in prompts["class_list"]]
    mapped = prompts["mapped_classes"]
    if not seq["classified"]:
        out["cls_logprob_err"] = float("inf")
    if not control:
        for f, c in seq["classified"]:
            got = seq["view_answers"].get((f, c))
            if got is None:
                out["cls_missing"] += 1
                continue
            name, score = _vote([names[k] for k in got[0]], got[1])
            if (mapped.index(name) != seq["cls"][f, c]
                    or np.float32(score) != seq["score"][f, c]):
                out["cls_missing"] += 1
    max_points = config["capacity"]["max_points"]
    images, keys = [], []
    for (f, c), raw in zip(seq["sample"], seq.get("sample_raw", [])):
        raw = raw[raw >= 0]
        pts = geometry.quantized(source.frames[f], max_points)[raw]
        images.append(render.views(torch.from_numpy(pts).float().to(device),
                                   **proj))
        keys.append((f, c))
    if not images:
        return
    grey = torch.cat(images)
    logits = torch.cat([ref_clip.class_logits(w, grey[i:i + 128], text, tower)
                        for i in range(0, len(grey), 128)])
    logits = logits.view(len(keys), NUM_VIEWS, -1).cpu()
    if control:
        cl = torch.cat([ref_clip.class_logits(w, grey[i:i + 128], text_c,
                                              tower, control=control)
                        for i in range(0, len(grey), 128)])
        cp = torch.softmax(cl.view(len(keys), NUM_VIEWS, -1).cpu(), -1)
        answers = {k: (cp[j].argmax(-1).numpy(), cp[j].amax(-1).numpy())
                   for j, k in enumerate(keys)}
    else:
        answers = seq["view_answers"]
    probs = torch.softmax(logits, dim=-1)
    for j, k in enumerate(keys):
        if k not in answers:
            continue
        idx, score = answers[k]
        idx = torch.as_tensor(np.asarray(idx, np.int64))
        v = torch.arange(len(idx))
        errs.append((torch.log(torch.as_tensor(np.asarray(score, np.float32)))
                     - torch.log(probs[j][v, idx])).abs())


def readings(sequences: list[dict], sources: list, config: dict, seed: int,
             device, control=False, info: dict | None = None
             ) -> dict[str, float]:
    """Each compared number over the window's finished sequences (the
    sequence k of the window was made as ``sources[k % len]``). ``info``
    receives what the check saw but does not compare."""
    info = {} if info is None else info
    out = dict(ground_kept_share=0.0, object_ground_share=0.0,
               ng_index_mismatch=0, ng_xyz_err_m=0.0, entropy_err=0.0,
               cluster_mismatch_share=0.0, plane_err_m=0.0,
               filter_mismatch=0, cls_missing=0, cls_logprob_err=0.0,
               _ground=0, _ground_kept=0, _high=0, _high_ground=0)
    errs = []
    tower, prompts = config["clip"], config["prompts"]
    with tf32(False):
        for k, seq in enumerate(sequences):
            _geometry(seq, sources[k % len(sources)], config, device,
                      control, out, info)
        if any(seq.get("sample") for seq in sequences):
            w = make_weights(tower, seed, device)
            tokens = torch.from_numpy(ref_clip.tokenize(
                [prompts["template"].format(c) for c in prompts["class_list"]],
                tower["vocab_size"], tower["context_length"])).to(device)
            text, text_c = (ref_clip.encode_text(w, tokens, tower, c)
                            for c in (False, control))
            text = text / text.norm(dim=-1, keepdim=True)
            text_c = text_c / text_c.norm(dim=-1, keepdim=True)
            for k, seq in enumerate(sequences):
                _classification(seq, sources[k % len(sources)], config, w,
                                text, text_c, device, control, out, errs)
    _worst(out, "cls_logprob_err",
           torch.cat(errs).max() if errs else float("inf"))
    out["ground_kept_share"] = out["_ground_kept"] / max(out["_ground"], 1)
    out["object_ground_share"] = (out["_high_ground"]
                                  / max(out["_high"], 1))
    for key in ("_ground", "_ground_kept", "_high", "_high_ground"):
        info[key[1:]] = int(out.pop(key))
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, name -> {value, limit})."""
    table = {k: {"value": values[k], "limit": v} for k, v in limits.items()}
    ok = all(np.isfinite(values[k]) and values[k] <= v
             for k, v in limits.items())
    return ok, table
