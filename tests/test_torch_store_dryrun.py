"""The port's live store dry run and its two store-facing example twins
against the reference's, on the CPU.

``repro_torch.launch.store_dryrun.live_sharded_smoke`` and
``live_replicated_smoke`` run beside the reference's at the sizes
scripts/verify.sh gives them.  With both packages' clocks frozen, the
returned dicts must be equal as a whole: every count and byte meter, the
registry snapshot, the Prometheus text, the Chrome trace and the last
sampled trace's span chain and tags.  A second run of the port on the
real clock must then give the same dict outside the fields that are
times, each named in ``_without_times``.  The quickstart twin must print
the reference quickstart's lines; the kv_serving twin, whose weights are
the port's own random ones, the same request, token and page-table
counts."""
from __future__ import annotations

import contextlib
import copy
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch.core as T
from repro_torch.analysis import epochsan as tsan
from repro_torch.kernels import ops as tops
from repro_torch.launch import store_dryrun as td

ROOT = Path(__file__).resolve().parents[1]
SMOKES = {
    "live_sharded_smoke": dict(shards=2, n_items=256, batch=32),
    "live_replicated_smoke": dict(shards=2, replicas=2, n_items=256,
                                  batch=32),
}
_STAGE_SECONDS = re.compile(
    r"^pipeline_(admit_s|export_s|dispatch_s|sync_stall_s|stall_fraction)\{")


def _run(clock, reset, san, smoke, frozen: bool, **kw) -> dict:
    # the read-dispatch meter and, under HONEYCOMB_EPOCHSAN=1, the
    # sanitizer (whose meters the registry collects) are process-wide in
    # both packages: count only this run's traffic
    reset()
    active = san.get()
    with contextlib.ExitStack() as stack:
        if active is not None:
            stack.enter_context(san.enabled(strict=active.strict))
        if frozen:
            stack.enter_context(clock.frozen())
        return smoke(**kw)


@pytest.fixture(scope="module")
def runs():
    """Each smoke through the reference (clock frozen) and the port (clock
    frozen, then on the real clock)."""
    import repro.core as J
    import repro.launch.store_dryrun as jd   # sets XLA_FLAGS on import
    from repro.analysis import epochsan as jsan
    from repro.kernels import ops as jops
    ref = (J.CLOCK, jops.reset_read_dispatches, jsan)
    port = (T.CLOCK, tops.reset_read_dispatches, tsan)
    out = {}
    for name, kw in SMOKES.items():
        out[name] = (
            _run(*ref, getattr(jd, name), True, **kw),
            _run(*port, getattr(td, name), True, device="cpu", **kw),
            _run(*port, getattr(td, name), False, device="cpu", **kw))
    return out


def _without_times(d: dict) -> dict:
    """``d`` without the fields the real clock moves, each a time:
    ``pipelined_epoch.sync_stall_s``; in ``telemetry.snapshot``
    ``pipeline_{admit,export,dispatch,sync_stall}_s`` and
    ``pipeline_stall_fraction``, and the sum, mean, min, max and
    percentiles of each ``*_latency_seconds`` histogram (its count stays);
    ``telemetry.prometheus`` and ``telemetry.chrome_trace``, which carry
    the same seconds and are compared with the clocks frozen."""
    d = copy.deepcopy(d)
    d.get("pipelined_epoch", {}).pop("sync_stall_s", None)
    tel = d["telemetry"]
    tel.pop("prometheus")
    tel.pop("chrome_trace")
    snap = {}
    for k, v in tel["snapshot"].items():
        if _STAGE_SECONDS.match(k):
            continue
        snap[k] = {"count": v["count"]} if isinstance(v, dict) else v
    tel["snapshot"] = snap
    return d


@pytest.mark.parametrize("name", list(SMOKES))
def test_live_smoke_matches_reference(runs, name):
    want, got, _ = runs[name]
    assert got["read_path"]["vmem_hits"] > 0
    assert set(got["telemetry"]["snapshot"]) \
        == set(want["telemetry"]["snapshot"])
    assert got["telemetry"]["last_trace"] == want["telemetry"]["last_trace"]
    assert got["telemetry"]["sampled_traces"] \
        == want["telemetry"]["sampled_traces"] > 0
    assert got == want


@pytest.mark.parametrize("name", list(SMOKES))
def test_live_smoke_real_clock_counts_match_reference(runs, name):
    want, _, got = runs[name]
    assert _without_times(got) == _without_times(want)
    hist = [k for k, v in got["telemetry"]["snapshot"].items()
            if isinstance(v, dict)]
    assert hist and all(k.split("{")[0].endswith("_latency_seconds")
                        for k in hist)


def test_live_smoke_meters(runs):
    """What the smokes assert and report beyond parity: one dirty shard
    after the confined burst, a cross-shard scan, log-fed followers."""
    got = runs["live_sharded_smoke"][1]
    assert got["dirty_shard_syncs_after_confined_burst"] == [1, 0]
    assert got["cross_shard_scan_items"] == 254
    assert got["read_path"]["fused_matches_reference"]
    rep = runs["live_replicated_smoke"][1]
    assert rep["feed"]["log_feed_epochs"] > 0 and rep["feed"]["log_replays"]
    assert rep["served_replica_lanes"] == [0, 1]


def test_store_dryrun_main_writes_results(tmp_path, monkeypatch):
    # main's live shard is the deployment's 500,000 keys; here a small one
    monkeypatch.setattr(td, "mesh_scale",
                        functools.partial(td.mesh_scale, shard_keys=3000))
    out = td.main(["--device", "cpu", "--out", str(tmp_path)])
    # the live smokes beside the mesh-scale half (on the CPU its stages
    # are not timed)
    assert set(out) == {"live_sharded_store", "live_replicated_store",
                        "workload", "slots_per_shard", "live_shard",
                        "peak_gb_per_chip", "argument_bytes",
                        "output_bytes", "temp_bytes", "collective_bytes",
                        "reads_per_s_per_chip_bound", "delta_sync",
                        "pipeline"}
    assert out["slots_per_shard"] == 14_681 and out["pipeline"] is None
    assert out["live_shard"]["keys"] == 3000
    assert {p.name for p in tmp_path.iterdir()} == {
        "torch_store_dryrun.json", "torch_store_dryrun_metrics.json",
        "torch_store_dryrun_trace.json"}
    assert "chrome_trace" not in out["live_replicated_store"]["telemetry"]


def _example(name: str, *args: str) -> list[str]:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                        *args], env=env, capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.splitlines()


def test_quickstart_twin_prints_reference_lines():
    want = _example("quickstart.py")
    got = _example("torch_quickstart.py", "--device", "cpu")
    assert len(want) > 15
    assert got == want


def test_kv_serving_twin_counts_match_reference():
    """Request and token counts, engine stats and the page table's puts,
    deletes, log appends, merges and sync commands: none depends on the
    weights (no request stops early).  The served tokens do."""
    want = _example("kv_serving.py")
    got = _example("torch_kv_serving.py", "--device", "cpu")
    drop_time = re.compile(r" in [0-9.]+s$")
    assert [drop_time.sub("", x) for x in got[:4]] \
        == [drop_time.sub("", x) for x in want[:4]]
    assert got[0].startswith("served 8 requests / 64 tokens")
    assert len(got) == len(want) == 8
    assert all(re.fullmatch(r"  rid \d+: \[(\d+, ){7}\d+\]", x)
               for x in got[4:])
