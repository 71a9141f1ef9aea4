"""BENCHMARK.json against the contract's shape: names, units, keys, and
every name found as a file."""
import json
import re

from benchmark.cell import ROOT, load

from benchmark.cell import ROOT as _BENCH

CHECKOUT = _BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
    assert len(set(names)) == len(names)


def test_metrics():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert {"frames_per_s", "peak_mem_gib", "setup_s"} <= e2e
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "metrics" / f"{m['name']}.py").exists()
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_loads():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for w in MANIFEST["workloads"]:
        workload, config, limits = load(w["name"])
        assert workload["config"] == w["config"] == config["name"]
        assert workload["traffic"] == w["traffic"]
        assert (CHECKOUT / configs[w["config"]]["file"]).exists()
        assert set(limits) == {
            "ground_kept_share", "object_ground_share", "ng_index_mismatch",
            "ng_xyz_err_m", "entropy_err", "cluster_mismatch_share",
            "plane_err_m", "filter_mismatch", "cls_missing",
            "cls_logprob_err"}
    for p in MANIFEST["paths"]:
        assert (CHECKOUT / p).is_dir()
