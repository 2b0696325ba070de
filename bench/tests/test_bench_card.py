"""On the card (skips elsewhere): a short run of each cell, traced, gives
a correct result with every per-layer metric its cell names."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload", cell, "--seed",
         str(2 ** 31 + 77), "--seconds", "8", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    want = {m["name"] for m in SPEC["per_layer"]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    for name, m in res["metrics"].items():
        if name.endswith("_roofline") or "mfu" in name:
            assert 0 < m["value"] <= 105, name
    dev = res["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    assert len(res["breakdown"]["device_ops"]) <= 10
