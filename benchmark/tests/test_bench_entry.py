"""The command's behaviour at its edges: no card, a checkout without the
program, and (on a card) one short run of a cell."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
CMD = [sys.executable, "-m", "benchmark.run", "--workload", "av2.urban",
       "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"]


def _run(cwd, hide_cards: bool):
    env = dict(os.environ, USE_FLAX="0")
    if hide_cards:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(CMD, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=900)


def test_no_card_exits_without_a_result():
    out = _run(CHECKOUT, hide_cards=True)
    assert out.returncode == 2 and out.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, hide_cards=False)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_a_cell_runs_on_the_card():
    out = _run(CHECKOUT, hide_cards=False)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    assert {"frames_per_s", "peak_mem_gib", "setup_s"} == set(line["metrics"])
