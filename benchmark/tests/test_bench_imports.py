"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference loads nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "vilgod_tpu"}
PROGRAM = "vilgod_tpu_torch"
REFERENCE_FILES = ["check.py", "weights.py", *(
    str(p.relative_to(BENCH)) for p in (BENCH / "reference").glob("*.py"))]


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def _loaded_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in list(sys.modules)})))"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"}, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_source_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & FORBIDDEN, path


def test_the_harness_and_the_program_load_no_jax():
    mods = ["benchmark.run", "benchmark.harness", "benchmark.check",
            "benchmark.calibrate", "benchmark.trace", *(
                f"benchmark.metrics.{p.stem}"
                for p in (BENCH / "metrics").glob("*.py")
                if p.stem != "__init__"),
            "vilgod_tpu_torch.pipeline", "vilgod_tpu_torch.pipeline.runner",
            "vilgod_tpu_torch.models.clip_wrapper",
            "vilgod_tpu_torch.models.vit_kernels",
            "vilgod_tpu_torch.ops.kernels", "vilgod_tpu_torch.ops.dense_kernels",
            "vilgod_tpu_torch.utils.cuda_build", "vilgod_tpu_torch.config"]
    loaded = _loaded_after("\n".join(f"import {m}" for m in mods))
    assert PROGRAM in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    for rel in REFERENCE_FILES:
        assert not _imports(BENCH / rel) & (FORBIDDEN | {PROGRAM}), rel
    loaded = _loaded_after("import benchmark.check, benchmark.weights")
    assert not loaded & (FORBIDDEN | {PROGRAM})


def test_forbidden_names_compare_whole():
    from benchmark.run import forbidden_modules
    assert "vilgod_tpu_torch" not in forbidden_modules()
