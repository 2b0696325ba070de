"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names; a run without a card, or without the program beside
the benchmark, prints no result."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ENV = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

DRIVE = """
import sys
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
import smoke
from bench import harness, run
import repro_torch.kernels.build, torch.profiler
c = smoke.cell("olmoe-1b-7b")
r, params = smoke.run(c, 5, seconds=1.0)
harness.judge(c, r, params, 5)
for name in ("prefill_ms_per_ktok", "decode_step_ms", "mfu",
             "paged_attention_roofline", "device_idle",
             "page_table_us_per_step"):
    harness.metric_reader(name)(r)
print("loaded", run.forbidden_modules())
sys.modules["repro.core"] = sys.modules["repro_torch"]
print("planted", run.forbidden_modules())
"""


def _python(code, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=ENV,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax():
    out = _python(DRIVE.format(src=str(ROOT / "src"), root=str(ROOT),
                               tests=str(Path(__file__).parent)))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "loaded []" in lines
    assert "planted ['repro']" in lines


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload", "olmoe-docqa",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload", "olmoe-docqa",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=ENV, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "No module named 'repro_torch'" in out.stderr
