"""honeylint, the CUDA kernel audit and EpochSan for the port
(``repro_torch.analysis``), on the CPU and without JAX.

Three layers, as ``tests/test_analysis.py`` holds them for the reference:

  * lint rules — each rule catches a known-bad fixture (written to
    tmp_path and run through ``lint_file``), the torch form of
    ``no-aliased-publish`` included, and ``src/repro_torch`` at HEAD
    lints clean under the port's own baseline and golden;
  * kernel check — ``check_record`` flags a deliberately broken record
    for every rule, ``check_sources`` flags a ``double``, and the real
    registry of ``kernels/ops.py`` entry points runs clean on the plain
    versions;
  * EpochSan — each injected protocol violation raises
    ``EpochSanViolation`` at the port's seams, and the same flows run
    clean without the injected bug.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import epochsan, kernel_check, lint
from repro_torch.analysis.kernel_check import DispatchRecord
from repro_torch.analysis.lint import Finding

REPO = Path(__file__).resolve().parents[1]


# --------------------------------------------------------------------------
# lint rules against bad fixtures
# --------------------------------------------------------------------------

def _lint_src(tmp_path, rel, source):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return lint.lint_file(path, root=tmp_path)


def _rules(findings):
    return {f.rule for f in findings}


def test_no_raw_clock_flags_time_calls(tmp_path):
    fs = _lint_src(tmp_path, "mod.py", """\
        import time

        def f():
            t0 = time.perf_counter()
            return time.time() - t0
    """)
    assert [f.rule for f in fs] == ["no-raw-clock", "no-raw-clock"]
    assert "repro_torch.core.telemetry" in fs[0].message


def test_no_raw_clock_exempts_the_clock_owner(tmp_path):
    fs = _lint_src(tmp_path, "core/telemetry.py", """\
        import time

        def now():
            return time.perf_counter()
    """)
    assert fs == []


def test_inline_suppression_with_reason(tmp_path):
    fs = _lint_src(tmp_path, "mod.py", """\
        import time

        def f():
            # honeylint: disable=no-raw-clock -- calibrating CLOCK itself
            return time.perf_counter()
    """)
    assert fs == []


def test_no_bare_except_flags_broad_handlers(tmp_path):
    fs = _lint_src(tmp_path, "mod.py", """\
        def f():
            try:
                g()
            except:
                pass
            try:
                g()
            except Exception:
                pass
            try:
                g()
            except (ValueError, KeyError):
                raise
    """)
    assert [f.rule for f in fs] == ["no-bare-except", "no-bare-except"]


@pytest.mark.parametrize("body", [
    # a bare from_numpy of a live host array (an attribute chain)
    """\
    def _publish_image(h):
        rows = h.ntype
        return torch.from_numpy(rows)
    """,
    # as_tensor shares the array's memory on the CPU too
    """\
    def _publish_image(h, dev):
        return torch.as_tensor(h.ntype, device=dev)
    """,
    # a view of a parameter is still the live array
    """\
    def _dev(self, arr):
        a = np.ascontiguousarray(arr)
        return torch.from_numpy(a)
    """,
    # .to(device) without copy=True returns the tensor itself on its device
    """\
    def stage(self, t, dev):
        return t.to(dev)
    """,
], ids=["from_numpy", "as_tensor", "view_of_param", "to_without_copy"])
def test_no_aliased_publish_flags_torch_aliasing(tmp_path, body):
    fs = _lint_src(tmp_path, "core/shard.py",
                   "import numpy as np\nimport torch\n\n\n"
                   + textwrap.dedent(body))
    assert [f.rule for f in fs] == ["no-aliased-publish"]


def test_no_aliased_publish_passes_copies(tmp_path):
    fs = _lint_src(tmp_path, "core/shard.py", """\
        import numpy as np
        import torch

        def _dev(self, arr):
            # the shard's own form (core/shard.py _dev)
            a = np.ascontiguousarray(arr)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            return torch.from_numpy(a).to(self.device, copy=True)

        def _publish_image(h):
            return torch.from_numpy(h.ntype).clone()

        def _publish_fresh(h):
            rows = np.array(h.ntype, copy=True)
            return torch.from_numpy(rows)

        def apply_snapshot(t, flags):
            # type conversions, not device moves
            return t.to(torch.int32), flags.to(dtype=torch.int64), \\
                flags.to(t.dtype)

        def helper(h):
            return torch.from_numpy(h.ntype)   # not a publish-path function
    """)
    assert fs == []


def test_no_aliased_publish_patrols_publish_files_only(tmp_path):
    fs = _lint_src(tmp_path, "core/btree.py", """\
        import torch

        def _publish_image(h):
            return torch.from_numpy(h.ntype)
    """)
    assert fs == []


def test_no_magic_image_offsets_flags_literal_indices(tmp_path):
    fs = _lint_src(tmp_path, "src/repro_torch/kernels/bad.py", """\
        def kern(rows_ref, out_ref):
            r = rows_ref[0]
            out_ref[r, 1217 + 3] = 1
    """)
    assert _rules(fs) == {"no-magic-image-offsets"}
    assert "1217" in fs[0].message


def test_no_magic_image_offsets_passes_layout_derived(tmp_path):
    fs = _lint_src(tmp_path, "src/repro_torch/kernels/good.py", """\
        def kern(rows_ref, out_ref, *, offs):
            r = rows_ref[0]
            out_ref[r, offs[0] + 3] = 1     # layout-derived
            out_ref[r, 4] = 2               # small lane arithmetic is fine
    """)
    assert fs == []


def test_stats_must_collect(tmp_path):
    fs = _lint_src(tmp_path, "mod.py", """\
        import dataclasses

        @dataclasses.dataclass
        class OrphanStats:
            n: int = 0

        @dataclasses.dataclass
        class WiredStats:
            n: int = 0

            def collect(self):
                return []

        @dataclasses.dataclass
        class NotAStatsThing:
            n: int = 0
    """)
    assert [f.rule for f in fs] == ["stats-must-collect"]
    assert "OrphanStats" in fs[0].message


def test_baseline_suppresses_by_rule_and_path(tmp_path):
    (tmp_path / "mod.py").write_text("import time\nt = time.time()\n")
    bp = tmp_path / "baseline.json"
    bp.write_text(json.dumps(
        [{"rule": "no-raw-clock", "path": "mod.py", "reason": "test debt"}]))
    findings, suppressed = lint.run_lint(
        ("mod.py",), root=tmp_path, baseline=bp, golden=None)
    assert findings == [] and suppressed == 1
    findings, suppressed = lint.run_lint(
        ("mod.py",), root=tmp_path, baseline=None, golden=None)
    assert _rules(findings) == {"no-raw-clock"} and suppressed == 0


def test_repo_at_head_lints_clean():
    """The port lints clean with at most 2 baselined findings, each
    baseline entry with a reason, and clean without the baseline too."""
    assert lint.DEFAULT_ROOTS == ("src/repro_torch",)
    findings, suppressed = lint.run_lint()
    assert findings == [], "\n".join(map(str, findings))
    assert suppressed <= 2
    base = lint.load_baseline()
    assert len(base) <= 2
    assert all(b.get("reason") for b in base), "baseline entries need reasons"
    bare, n = lint.run_lint(baseline=None)
    assert {(f.rule, f.path) for f in bare} <= {
        (b["rule"], b["path"]) for b in base} and n == 0


def test_publish_path_copy_is_patrolled():
    """The shard's host -> device conversion is a publish function, and it
    copies: dropping its ``copy=True`` is a finding."""
    src = (REPO / "src/repro_torch/core/shard.py").read_text()
    assert "torch.from_numpy(a).to(self.device, copy=True)" in src
    assert lint.PUBLISH_FN.search("_dev")
    bad = src.replace("torch.from_numpy(a).to(self.device, copy=True)",
                      "torch.from_numpy(a).to(self.device)")
    linter = lint._FileLinter("src/repro_torch/core/shard.py", bad)
    import ast
    linter.visit(ast.parse(bad))
    assert {f.rule for f in linter.findings} == {"no-aliased-publish"}


def test_golden_schema_pin_roundtrip(tmp_path):
    golden = tmp_path / "golden.json"
    assert _rules(lint.check_golden(golden)) == {"schema-golden-drift"}
    lint.pin_golden(golden)
    assert lint.check_golden(golden) == []
    blob = json.loads(golden.read_text())
    blob["sha256"] = "0" * 64
    blob["detail"]["image_words"] = -1
    golden.write_text(json.dumps(blob))
    fs = lint.check_golden(golden)
    assert _rules(fs) == {"schema-golden-drift"}
    assert "image_words" in fs[0].message


def test_repo_golden_matches_current_schema():
    assert lint.GOLDEN_PATH == (REPO / "src/repro_torch/analysis"
                                / "golden_schema.json")
    assert lint.check_golden() == []


def test_port_golden_is_the_reference_golden_byte_for_byte():
    mine = (REPO / "src/repro_torch/analysis/golden_schema.json").read_bytes()
    theirs = (REPO / "src/repro/analysis/golden_schema.json").read_bytes()
    assert mine == theirs


def test_finding_formatting():
    f = Finding("no-raw-clock", "src/x.py", 7, "msg")
    assert str(f) == "src/x.py:7: [no-raw-clock] msg"
    assert f.to_json() == {"rule": "no-raw-clock", "path": "src/x.py",
                           "line": 7, "message": "msg"}


# --------------------------------------------------------------------------
# kernel check
# --------------------------------------------------------------------------

def _record(**kw):
    base = dict(device="cuda", counter="fused_get",
                ops=[("aten.empty.memory_format", ["torch.int32"])],
                launches={"fused_get": 1, "fused_scan": 0, "row_scatter": 0},
                aliased=True, dst_bytes=4096, readbacks=0, alloc_rise=512,
                smem=[("default", 22668)])
    base.update(kw)
    return DispatchRecord(**base)


def _check(rec, **kw):
    return kernel_check.check_record("e", "x.py", rec, **kw)


def test_check_record_passes_a_clean_record():
    assert _check(_record(), in_place=True, fused=True) == []


def test_check_record_flags_f64():
    rec = _record(ops=[("aten.mul.Tensor", ["torch.float32",
                                            "torch.float64"])])
    assert _rules(_check(rec)) == {"kernel-no-f64"}
    rec = _record(ops=[("aten.view_as_complex.default",
                        ["torch.complex128"])])
    assert _rules(_check(rec)) == {"kernel-no-f64"}


def test_check_record_flags_a_scatter_that_copies():
    fs = _check(_record(aliased=False), in_place=True)
    assert _rules(fs) == {"kernel-inplace-alias"}
    fs = _check(_record(alloc_rise=4096), in_place=True)
    assert _rules(fs) == {"kernel-inplace-alias"}
    assert "4096" in fs[0].message
    # the same record audited as a plain kernel is clean
    assert _check(_record(aliased=False, alloc_rise=4096)) == []


@pytest.mark.parametrize("launches", [
    {"fused_get": 2, "fused_scan": 0},
    {"fused_get": 0, "fused_scan": 0},
    {"fused_get": 1, "row_scatter": 1},
], ids=["split", "none", "stray"])
def test_check_record_flags_a_split_fused_path(launches):
    fs = _check(_record(launches=launches), fused=True)
    assert _rules(fs) == {"kernel-single-dispatch"}
    # the CPU runs the plain version, which launches nothing: unchecked
    assert _check(_record(device="cpu", launches=launches, readbacks=None,
                          alloc_rise=None), fused=True) == []


def test_check_record_flags_readbacks_above_the_pin():
    fs = _check(_record(readbacks=2), readbacks=1)
    assert _rules(fs) == {"kernel-host-readback"}
    assert _check(_record(readbacks=1), readbacks=1) == []
    assert _check(_record(readbacks=None)) == []


def test_check_record_flags_shared_memory_over_the_limit():
    fs = _check(_record(smem=[("a", 100), ("largest", 232449)]))
    assert _rules(fs) == {"kernel-smem-budget"} and "largest" in fs[0].message
    assert _check(_record(smem=[("a", 232448)])) == []
    fs = _check(_record(smem=[("a", 100)]), smem_limit=64)
    assert _rules(fs) == {"kernel-smem-budget"}


def test_check_record_flags_a_mirror_off_its_launcher():
    fs = _check(_record(smem_launcher=[("default", 22668, 22672)]))
    assert _rules(fs) == {"kernel-smem-budget"}
    assert _check(_record(smem_launcher=[("default", 22668, 22668)])) == []


def test_check_sources_flags_double_outside_comments(tmp_path):
    (tmp_path / "a.cu").write_text(
        "// double in a comment\n/* and a\n double here */\n"
        "__global__ void k(float* x) { double y = x[0]; }\n")
    (tmp_path / "b.cuh").write_text("int doubled = 2;  // double\n")
    fs = kernel_check.check_sources(tmp_path, root=tmp_path)
    assert [(f.rule, f.path, f.line) for f in fs] \
        == [("kernel-no-f64", "a.cu", 4)]


def test_kernel_sources_hold_no_double():
    assert kernel_check.check_sources() == []
    assert len(list(kernel_check.CSRC.glob("*.cu*"))) >= 9


def test_kernel_registry_runs_clean_on_the_plain_versions():
    """Every entry point of ``kernels/ops.py`` runs on the CPU, records a
    dispatch and passes every rule the CPU can check."""
    findings, runs = kernel_check.run_kernel_checks("cpu")
    assert findings == [], "\n".join(map(str, findings))
    names = {e.name for e, _ in runs}
    assert names == {
        "ops.snapshot_delta_scatter", "ops.snapshot_image_scatter",
        "ops.snapshot_multi_scatter", "ops.log_replay_scatter",
        "ops.batched_get_fused", "ops.batched_scan_fused", "ops.key_search",
        "ops.key_search_image", "ops.leaf_merge", "ops.paged_attention",
        "ops.moe_grouped"}
    for entry, rec in runs:
        assert rec.ops, entry.name            # the plain version's aten ops
        assert rec.readbacks is None and rec.alloc_rise is None
        assert all(v == 0 for v in rec.launches.values()), entry.name
        assert rec.smem and all(b >= 0 for _, b in rec.smem)
        if entry.in_place:
            assert rec.aliased, entry.name
        if entry.readbacks:
            assert entry.readback_reason
    counters = {e.counter for e, _ in runs}
    from repro_torch.kernels import build
    assert counters == set(build.LAUNCHES)


def test_kernel_check_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        kernel_check.run_kernel_checks("cuda")


def test_fused_read_smem_mirror_at_the_default_geometry():
    """The mirror's sum, term by term, at the store's default config."""
    from repro_torch.core import HoneycombConfig, NodeImageLayout
    from repro_torch.kernels import fused_read
    cfg = HoneycombConfig()
    IW = NodeImageLayout.for_config(cfg).image_words
    ww = (2 * cfg.key_words + IW + 4 * (cfg.node_cap + cfg.log_cap)
          + cfg.max_scan_items * (cfg.key_words + cfg.val_words + 2)
          + cfg.key_words + cfg.val_words)
    assert fused_read.warp_words(cfg) == ww
    assert fused_read.smem_bytes(cfg, cfg.cache_slots) \
        == (cfg.cache_slots + IW + 2 * ww) * 4
    src = (kernel_check.CSRC / "fused_read.cu").read_text()
    assert "constexpr int WARPS = 2;" in src
    assert f"constexpr int MAX_SMEM = {fused_read.MAX_SMEM};" in src


# --------------------------------------------------------------------------
# EpochSan
# --------------------------------------------------------------------------

def _seeded_shard(cfg=None, n=20):
    from repro_torch.core.shard import StoreShard
    s = StoreShard(cfg, device="cpu")
    for i in range(n):
        s.put(f"k{i:03d}".encode(), b"v" * 8)
    s.export_snapshot()
    return s


def test_epochsan_clean_lifecycle_counts_checks():
    with epochsan.enabled() as san:
        s = _seeded_shard()
        assert s.get_batch([b"k001"]) == [b"v" * 8]
        assert s.scan_batch([(b"k001", b"k002")]) \
            == [[(b"k001", b"v" * 8), (b"k002", b"v" * 8)]]
        for i in range(20):
            s.put(f"k{i:03d}".encode(), b"w" * 8)
        s.begin_export()
        s.flip()
        s.collect_garbage()
        assert s.get_batch([b"k001"]) == [b"w" * 8]
    assert san.violations == []
    st = san.stats
    assert st.read_checks == 3 and st.stagings == 2 and st.flips == 2
    assert st.gc_audits == 1 and st.violations == 0


@pytest.mark.parametrize("read", ["get", "scan"])
def test_epochsan_catches_standby_read(read):
    from repro_torch.kernels import build
    with epochsan.enabled() as san:
        s = _seeded_shard()
        s.put(b"k000", b"x" * 8)
        s.begin_export()            # staged, NOT flipped
        lanes0 = s.pipeline_stats.dispatched_lanes
        launches0 = dict(build.LAUNCHES)
        with pytest.raises(epochsan.EpochSanViolation) as ei:
            if read == "get":
                s._device_get(s._standby, [b"k000"])
            else:
                s._device_scan(s._standby, [(b"k000", b"k001")], None)
        assert ei.value.kind == epochsan.STANDBY_READ
        # raised at the seam: before any packing, metering or launch
        assert s.pipeline_stats.dispatched_lanes == lanes0
        assert build.LAUNCHES == launches0
    assert san.stats.violations == 1


def test_epochsan_nonstrict_records_without_raising():
    with epochsan.enabled(strict=False) as san:
        s = _seeded_shard()
        s.put(b"k000", b"x" * 8)
        s.begin_export()
        assert s._device_get(s._standby, [b"k000"]) == [b"x" * 8]
    assert [v.kind for v in san.violations] == [epochsan.STANDBY_READ]
    assert san.report()[0]["kind"] == epochsan.STANDBY_READ


def test_epochsan_catches_pinned_epoch_gc(monkeypatch):
    from repro_torch.core import gc as gc_mod
    from repro_torch.core.config import HoneycombConfig

    with epochsan.enabled() as san:
        # "explicit" pins the exported snapshot's accelerator epoch
        s = _seeded_shard(HoneycombConfig(sync_policy="explicit"), n=40)
        for i in range(40):
            s.update(f"k{i:03d}".encode(), b"w" * 8)
        assert s.tree.gc.list, "updates must have deferred garbage"
        monkeypatch.setattr(gc_mod.GarbageCollector, "_reclaimable",
                            lambda self, e: True)
        with pytest.raises(epochsan.EpochSanViolation) as ei:
            s.collect_garbage()
        assert ei.value.kind == epochsan.PINNED_EPOCH_GC
    assert san.stats.violations >= 1


def test_epochsan_catches_follower_freshness(monkeypatch):
    from repro_torch.core.config import ReplicationConfig
    from repro_torch.core.replica import ReplicaGroup
    from repro_torch.core.shard import StoreShard

    with epochsan.enabled() as san:
        g = ReplicaGroup(StoreShard(device="cpu"),
                         ReplicationConfig(replicas=2))
        for i in range(20):
            g.put(f"k{i:03d}".encode(), b"v" * 8)
        g.export_snapshot()
        assert g.get_batch([b"k001"], replica=1) == [b"v" * 8]
        assert g.scan_batch([(b"k001", b"k001")], replica=1) \
            == [[(b"k001", b"v" * 8)]]
        assert san.stats.dispatch_checks == 2 and not san.violations

        g.pause_follower(1)
        for i in range(20):
            g.put(f"k{i:03d}".encode(), b"w" * 8)
        g.export_snapshot()
        g.resume_follower(1)
        monkeypatch.setattr(ReplicaGroup, "_covers", lambda self, f: True)
        with pytest.raises(epochsan.EpochSanViolation) as ei:
            g.get_batch([b"k001"], replica=1)
        assert ei.value.kind == epochsan.FOLLOWER_FRESHNESS


def test_epochsan_catches_stale_cache_rows():
    with epochsan.enabled() as san:
        s = _seeded_shard()
        s.put(b"k000", b"w" * 8)
        s.tree.pt.remap(0, s.tree.pt.lookup(0))    # remap hits the cache
        s.cache.refresh = lambda tree: None        # "forgot to refresh"
        with pytest.raises(epochsan.EpochSanViolation) as ei:
            s.begin_export()
        assert ei.value.kind == epochsan.STALE_CACHE_ROWS
    assert san.stats.violations == 1


def test_epochsan_remap_then_refresh_stages_clean():
    with epochsan.enabled() as san:
        s = _seeded_shard()
        s.put(b"k000", b"w" * 8)
        s.tree.pt.remap(0, s.tree.pt.lookup(0))
        s.export_snapshot()     # begin_export refreshes the cache itself
    assert san.violations == []


def test_epochsan_catches_unflipped_export():
    from repro_torch.core.scheduler import OutOfOrderScheduler
    from repro_torch.core.shard import StoreShard

    with epochsan.enabled() as san:
        s = StoreShard(device="cpu")
        for i in range(10):
            s.put(f"k{i:03d}".encode(), b"v" * 8)
        sched = OutOfOrderScheduler(pipeline="pipelined")
        s.flip = lambda: None                      # "forgot to publish"
        with pytest.raises(epochsan.EpochSanViolation) as ei:
            sched.stage_export(s)
        assert ei.value.kind == epochsan.UNFLIPPED_EXPORT
    assert san.stats.violations == 1


def test_epochsan_gating_matches_environment():
    before = epochsan.get()
    env_on = os.environ.get(epochsan.ENV_VAR, "").strip() not in (
        "", "0", "false")
    if env_on:
        assert before is not None
    with epochsan.enabled() as san:
        assert epochsan.get() is san and san is not before
    assert epochsan.get() is before


def test_epochsan_stats_collects_registry_samples():
    with epochsan.enabled() as san:
        _seeded_shard(n=5)
        names = {s.name for s in san.stats.collect()}
    assert names == {f"epochsan_{f}" for f in (
        "read_checks", "stagings", "flips", "gc_audits", "dispatch_checks",
        "violations")}


def test_telemetry_registers_the_sanitizer_when_active():
    from repro_torch.core import Telemetry, TelemetryConfig
    with epochsan.enabled():
        s = _seeded_shard(n=5)
        tel = Telemetry(TelemetryConfig()).wire_store(s)
        keys = set(tel.registry.snapshot())
    assert any(k.startswith("epochsan_stagings") for k in keys), keys
    tel = Telemetry(TelemetryConfig()).wire_store(s)
    if epochsan.get() is None:
        assert not any("epochsan" in k for k in tel.registry.snapshot())


# --------------------------------------------------------------------------
# the runner and imports
# --------------------------------------------------------------------------

def test_runner_writes_report(tmp_path):
    from repro_torch.analysis import runner
    out = tmp_path / "report.json"
    rc = runner.main(["--json", str(out), "--device", "cpu"])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["ok"] and report["lint"] == [] \
        and report["kernel_check"] == []
    assert report["entry_points"] == 11 and report["baselined"] <= 2
    assert report["device"] == "cpu" and len(report["entries"]) == 11
    assert all(e["findings"] == [] for e in report["entries"])


def test_runner_defaults_to_the_card():
    from repro_torch.analysis import runner
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        runner.main([])


def test_port_imports_without_jax_or_the_reference():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.analysis, repro_torch.core\n"
            "from repro_torch.analysis import epochsan, kernel_check, lint, "
            "runner\n"
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.') "
            "for m, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_epochsan_counts_nothing_after_its_scope():
    """Seams passed after a scope ends reach no sanitizer of that scope:
    its meters stay as they were, and a later scope starts from zero."""
    with epochsan.enabled() as san:
        s = _seeded_shard()
        s.put(b"k000", b"x" * 8)
        s.export_snapshot()
    n = dataclasses.asdict(san.stats)
    assert n["stagings"] > 0 and n["flips"] > 0
    s.put(b"k001", b"y" * 8)
    s.export_snapshot()
    s._device_get(s._snapshot, [b"k001"])
    assert dataclasses.asdict(san.stats) == n
    with epochsan.enabled() as again:
        assert again is not san
        s._device_get(s._snapshot, [b"k001"])
    assert again.stats.read_checks == 1 and again.stats.violations == 0
