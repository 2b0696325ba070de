"""A run on the CPU at the port's smoke sizes: correct when sound; not
correct with the float8 control in the program's place, nor with the
timed path broken underneath (each fault a served cell can have); a
cell, a mix and a metric found by name; the trace's reading."""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import smoke
from bench import check, devtrace, faults, harness

MODELS = ["olmoe-1b-7b", "jamba-v0.1-52b"]
ROOT = Path(__file__).resolve().parents[2]


def _judge(c, seed, seconds=3.0):
    r, params = smoke.run(c, seed, seconds)
    ok, checks, sample, gaps = harness.judge(c, r, params, seed)
    return ok, checks, sample, params


@pytest.mark.parametrize("name", MODELS)
def test_sound_run_is_correct(name):
    c = smoke.cell(name)
    ok, checks, sample, _ = _judge(c, 2 ** 31 + 3)
    assert ok, checks
    assert len(sample) >= 2 and checks["failed_requests"]["value"] == 0


@pytest.mark.parametrize("name", MODELS)
def test_control_fails(name):
    """The reference in float8 in the program's place: at each served
    position the token it puts first reads a mean gap over the limit."""
    c = smoke.cell(name)
    ok, checks, sample, params = _judge(c, 11, seconds=4.0)
    assert ok
    arch = c.config["arch"]
    ref = check.reference_logits(c.reference, params, arch, sample)
    ctl = check.reference_logits(c.reference, params, arch, sample, "fp8")
    g = np.concatenate([check.gaps(r, x.argmax(-1))
                        for r, x in zip(ref, ctl)])
    assert g.mean() > smoke.LIMIT
    assert not check.verdict(c.limits, float(g.mean()), 0, len(sample))[0]


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("fault", sorted(faults.ALL))
def test_broken_timed_path_is_not_correct(fault, name):
    """One chip: no exchange between chips to leave out."""
    c = smoke.cell(name)
    with faults.ALL[fault]():
        ok, checks, _, _ = _judge(c, 2 ** 31 + 3)
    assert not ok, checks


def test_verdict_holds_the_off_top_share_where_named():
    lim = {"mean_gap": {"limit": 0.2}, "off_top_share": {"limit": 0.35}}
    assert check.verdict(lim, 0.1, 0, 3, 0.3)[0]
    ok, checks = check.verdict(lim, 0.1, 0, 3, 0.4)
    assert not ok and not check.verdict(lim, 0.1, 0, 3, None)[0]
    assert list(checks) == ["mean_gap", "failed_requests",
                            "checked_requests", "off_top_share"]
    assert "off_top_share" not in check.verdict(
        {"mean_gap": {"limit": 0.2}}, 0.1, 0, 3, 0.9)[1]


def test_cell_mix_and_metric_found_by_name(tmp_path):
    """A new cell is files plus entries in BENCHMARK.json: the harness
    finds its configuration, mix, limits and a new per-layer metric by
    name, and runs it, with no edit of its own code."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "bench"
    shutil.copytree(ROOT / "bench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    arch = smoke.arch("olmoe-1b-7b")
    (bench / "configs" / "olmoe-smoke.json").write_text(json.dumps(
        {"name": "olmoe-smoke", "arch": arch}))
    (bench / "traffic" / "smoke_mix.json").write_text(json.dumps(smoke.MIX))
    (bench / "limits" / "olmoe-smoke-cell.json").write_text(json.dumps(
        {"mean_gap": {"limit": smoke.LIMIT}}))
    (bench / "metrics" / "prompts_prefilled.py").write_text(
        "def read(run):\n"
        "    return sum(len(s.prefills) for s in run.steps) or None\n")
    spec["configs"].append({"name": "olmoe-smoke", "source": "test",
                            "file": "bench/configs/olmoe-smoke.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "olmoe-smoke-cell",
                              "config": "olmoe-smoke",
                              "traffic": "smoke_mix", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "prompts_prefilled", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "serving engine",
                              "moves": "tokens_per_s",
                              "workloads": ["olmoe-smoke-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = harness.load_cell("olmoe-smoke-cell", tmp_path)
    assert c.traffic == smoke.MIX and c.config["arch"] == arch
    assert [m["name"] for m in c.per_layer] == ["prompts_prefilled"]
    loop, params = harness.set_up(c, 4, device="cpu",
                                  engine_factory=smoke.f32_engine)
    r = harness.measure(loop, c, 2.0, False)
    read = harness.metric_reader("prompts_prefilled", bench)
    assert read(r) >= 1
    assert harness.judge(c, r, params, 4)[0]
    assert "tokens_per_s" in harness.end_to_end(r, 1.0)


class _Event:
    def __init__(self, name, dev, s, e, corr=0):
        self._v = (name, dev, s * 1000, e * 1000, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_trace_reading():
    """Busy time, kernels by name, device time by the range its launch
    ran in, the longest idle gaps, on a synthetic trace (microseconds)."""
    from torch.autograd import DeviceType
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    evs = [
        _Event(devtrace.WINDOW, cpu, 0, 1000),
        _Event("engine.decode", cpu, 100, 600),
        _Event("page_table.lookup", cpu, 120, 200),
        _Event("cudaLaunchKernel", cpu, 130, 135, 7),
        _Event("cudaMemcpyAsync", cpu, 140, 145, 8),
        _Event("cudaLaunchKernel", cpu, 300, 305, 9),
        _Event("fused_read_kernel", cuda, 150, 170, 7),
        _Event("Memcpy HtoD", cuda, 170, 172, 8),
        _Event("paged_attention_kernel_split", cuda, 310, 410, 9),
        _Event("engine.decode", cuda, 100, 600),      # the mirrored range
        _Event("elementwise", cuda, 800, 850),
    ]
    t = devtrace.analyse(evs)
    assert t.window_us == 1000 and t.busy_us == 20 + 2 + 100 + 50
    assert t.kernels["paged_attention_kernel_split"] == (1, 100)
    assert "engine.decode" not in t.kernels
    assert t.range_device_us["page_table.lookup"] == 22
    assert t.range_device_us["engine.decode"] == 100
    assert t.idle_gaps[0] == ("host outside the engine's calls", 390)
    assert t.idle_gaps[1] == ("engine.decode", 138)
    with pytest.raises(RuntimeError):
        devtrace.analyse(evs[:6])


def test_metric_readers_on_a_run():
    c = smoke.cell("olmoe-1b-7b")
    r, _ = smoke.run(c, 6, 2.0)
    r.trace = devtrace.Trace(2e6, 5e5, {"paged_attention_kernel_split":
                                        (4, 10.0)},
                             {"page_table.lookup": 30.0}, [])
    r.trace_steps = r.steps
    read = {m: harness.metric_reader(m)(r) for m in (
        "prefill_ms_per_ktok", "decode_step_ms", "mfu",
        "paged_attention_roofline", "device_idle", "page_table_us_per_step")}
    assert read["device_idle"] == pytest.approx(75.0)
    steps = [s for s in r.steps if s.decoded]
    assert read["page_table_us_per_step"] == pytest.approx(30 / len(steps))
    assert read["decode_step_ms"] == pytest.approx(
        1e3 * np.mean([s.decode_s for s in steps]))
    assert all(v > 0 for v in read.values())
    assert read["mfu"] < 100 and read["paged_attention_roofline"] > 0
