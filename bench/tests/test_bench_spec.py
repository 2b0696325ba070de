"""BENCHMARK.json keeps to the benchmark's contract, and every file a cell
is made of is where the harness looks for it by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = ["command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"]
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden_size|intermediate|latent|state|proj|head_dim|"
                   r"_dim$|_rank$|expand|experts_per_tok)")


def line(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s \
        and "\t" not in s


def test_keys_and_limits():
    assert list(SPEC) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert isinstance(SPEC["run_seconds"], int) \
        and 1 <= SPEC["run_seconds"] <= 51
    # 2 + 14 runs a cell of run_seconds + 60 s, 2 x 90 s a cell to
    # compile, 1,200 s spare, with all 24 cells, inside 43,200 s
    cells = 24
    assert (2 + 14 * cells) * (SPEC["run_seconds"] + 60) + cells * 180 \
        + 1200 <= 43200


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]] \
        + [w["name"] for w in SPEC["workloads"]] \
        + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]] \
        + [w["traffic"] for w in SPEC["workloads"]] \
        + [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in SPEC["workloads"]}) \
        == len(SPEC["workloads"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and line(c["why"]) and line(c["source"])
        assert c["file"].startswith("bench/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert not WIDTH.search(k), k
            assert k in body and body[k] != body["published"][k]
        assert set(body["published"]) == set(c["reduced"])


def test_workloads():
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = set()
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "bench" / "limits" / f"{w['name']}.json").exists()


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = [w["name"] for w in SPEC["workloads"]]

    def reported(m):
        return m.get("workloads", cells)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"]) and m["moves"] in e2e
        # every cell that reads the metric reports what it moves
        assert set(reported(m)) <= set(reported(e2e[m["moves"]]))
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    # beside each roofline, a whole-step share of the peak moving the
    # same end-to-end metric
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       for o in SPEC["per_layer"])
    for cell in cells:
        e = [n for n, m in e2e.items() if cell in reported(m)]
        assert "setup_s" in e and len(e) >= 2
        assert any(cell in reported(m) for m in SPEC["per_layer"])
    text = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in text, layer


def test_reference_modules():
    """Each configuration file's ``reference``, where present, names a
    module under bench/reference/ that exports the contract's functions
    (``model`` where absent)."""
    from bench import harness
    for c in SPEC["configs"]:
        body = json.loads((ROOT / c["file"]).read_text())
        module = body.get("reference", "model")
        assert NAME.match(module), module
        assert (ROOT / "bench" / "reference" / f"{module}.py").is_file()
        ref = harness.reference_module(body)
        for f in harness.REFERENCE_EXPORTS:
            assert callable(getattr(ref, f, None)), (module, f)
        if any(k == "M" for k, _ in ref.layer_kinds(body["arch"])):
            assert hasattr(ref, "ssm_flops") or hasattr(ref, "ssm_dims")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_limits_files(cell):
    lim = json.loads((ROOT / "bench" / "limits" / f"{cell}.json")
                     .read_text())
    assert lim["mean_gap"]["limit"] > 0
