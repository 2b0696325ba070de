"""A configuration names its own plain reference: a module under
``bench/reference/`` that the harness draws the weights from, judges
with and counts with, found by name in a copy of the checkout with no
edit of the harness, the check, the counts or a metric.  The two
configurations' counts, pinned, through the module each resolves to."""
import json
import shutil
from pathlib import Path

import pytest
import torch

import smoke
from bench import counts, harness

ROOT = Path(__file__).resolve().parents[2]
MODEL = (ROOT / "bench" / "reference" / "model.py").read_text()

#: appended to a copy of model.py: the logits rolled one place along
#: the vocabulary
ROLLED = '''

_logits_at = logits_at


def logits_at(*a, **kw):
    return [torch.roll(lg, 1, dims=-1) for lg in _logits_at(*a, **kw)]
'''
#: appended to a copy of model.py: one leaf more in the layout
EXTRA_LEAF = '''

_layout = layout


def layout(arch):
    out = _layout(arch)
    out["extra"] = ((3, 5), F32, "ones")
    return out
'''
OWN_SSM_FLOPS = 1e6
#: appended to a copy of model.py: its own count of the Mamba layers
OWN_SSM = f'''

def ssm_flops(arch):
    return {OWN_SSM_FLOPS!r}
'''

#: (active_body_params, decode_flops(32, 40,000), prefill_flops(1,536),
#: paged_attention_bytes(40,000, 32), attention_layers) of each
#: configuration file's arch block: what mfu and paged_attention_roofline
#: have counted in every run of its cells
PINNED = {
    "olmoe-1b-7b": (1075904512.0, 80694214656.0, 3460104192000.0,
                    327942144, 16),
    "jamba-v0.1-52b": (2865778400.0, 201435944960.0, 8832711163904.0,
                       164364288, 1),
}


def _checkout(tmp_path, modules: dict, arch: dict) -> Path:
    """A copy of BENCHMARK.json and bench/ in ``tmp_path``, with, for
    each module name -> source, the file ``bench/reference/<module>.py``,
    a smoke configuration ``smoke-<module>`` that names it, and its cell
    ``smoke-<module>-cell``."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "bench"
    shutil.copytree(ROOT / "bench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / "traffic" / "smoke_mix.json").write_text(json.dumps(smoke.MIX))
    for module, source in modules.items():
        name = f"smoke-{module}"
        (bench / "reference" / f"{module}.py").write_text(source)
        (bench / "configs" / f"{name}.json").write_text(json.dumps(
            {"name": name, "reference": module, "arch": arch}))
        (bench / "limits" / f"{name}-cell.json").write_text(json.dumps(
            {"mean_gap": {"limit": smoke.LIMIT}}))
        spec["configs"].append({"name": name, "source": "test",
                                "file": f"bench/configs/{name}.json",
                                "reduced": [], "why": "test"})
        spec["workloads"].append({"name": f"{name}-cell", "config": name,
                                  "traffic": "smoke_mix", "chips": 1,
                                  "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def _cell(root: Path, module: str) -> harness.Cell:
    c = harness.load_cell(f"smoke-{module}-cell", root)
    assert Path(c.reference.__file__) \
        == root / "bench" / "reference" / f"{module}.py"
    return c


def _judged(c: harness.Cell, seed: int):
    loop, params = harness.set_up(c, seed, device="cpu",
                                  engine_factory=smoke.f32_engine)
    r = harness.measure(loop, c, 3.0, False)
    assert r.ref is c.reference
    return harness.judge(c, r, params, seed)


def test_a_named_reference_is_run_and_judged(tmp_path):
    root = _checkout(tmp_path, {"copy": MODEL}, smoke.arch("olmoe-1b-7b"))
    ok, checks, _, _ = _judged(_cell(root, "copy"), 2 ** 31 + 9)
    assert ok, checks


def test_the_named_reference_does_the_judging(tmp_path):
    """The copy's logits rolled one place: the same served tokens read
    far below its best."""
    root = _checkout(tmp_path, {"rolled": MODEL + ROLLED},
                     smoke.arch("olmoe-1b-7b"))
    ok, checks, _, _ = _judged(_cell(root, "rolled"), 2 ** 31 + 9)
    assert not ok
    assert checks["mean_gap"]["value"] > smoke.LIMIT
    assert checks["failed_requests"]["value"] == 0


def test_a_named_layout_is_drawn(tmp_path):
    root = _checkout(tmp_path, {"wider": MODEL + EXTRA_LEAF},
                     smoke.arch("olmoe-1b-7b"))
    c = _cell(root, "wider")
    _, params = harness.set_up(c, 4, device="cpu",
                               engine_factory=smoke.f32_engine)
    assert torch.equal(params["extra"], torch.ones(3, 5))
    assert set(params) == {"embed", "blocks", "final_norm", "lm_head",
                           "extra"}


def test_a_named_ssm_count_moves_the_counts_and_mfu(tmp_path):
    arch = smoke.arch("jamba-v0.1-52b")
    root = _checkout(tmp_path, {"own_ssm": MODEL + OWN_SSM}, arch)
    own = _cell(root, "own_ssm").reference
    base = harness.reference_module({"arch": arch}, root / "bench")
    assert counts.ssm_flops(own, arch) == OWN_SSM_FLOPS
    delta = OWN_SSM_FLOPS - counts.ssm_flops(base, arch)
    assert delta != 0
    assert counts.prefill_flops(own, arch, 1536) \
        - counts.prefill_flops(base, arch, 1536) \
        == pytest.approx(1536 * delta, rel=1e-12)
    assert counts.decode_flops(own, arch, 32, 40_000) \
        - counts.decode_flops(base, arch, 32, 40_000) \
        == pytest.approx(32 * delta, rel=1e-12)
    steps = [harness.Step(1.0, [(1536, 0.1), (700, 0.05)], 0, 0, None),
             harness.Step(2.0, [], 32, 40_000, 0.01)]
    mfu = harness.metric_reader("mfu", root / "bench")

    def read(ref):
        return mfu(harness.Run(arch, 32, 0.0, 2.0, [], steps, ref=ref))
    tokens = 1536 + 700 + 32
    assert read(own) - read(base) == pytest.approx(
        100.0 * tokens * delta / (2.0 * counts.PEAK_BF16_FLOPS), rel=1e-9)


def test_a_missing_reference_fails_at_load_cell(tmp_path):
    root = _checkout(tmp_path, {"copy": MODEL}, smoke.arch("olmoe-1b-7b"))
    (root / "bench" / "reference" / "copy.py").unlink()
    with pytest.raises(FileNotFoundError, match="reference/copy.py"):
        harness.load_cell("smoke-copy-cell", root)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_pinned_counts_through_the_resolver(name):
    """A configuration without ``"reference"`` resolves to model.py, and
    the counts through it are what they have always been, to the bit."""
    config = harness.config_file(name)
    ref = harness.reference_module(config)
    assert "reference" not in config
    assert Path(ref.__file__) == ROOT / "bench" / "reference" / "model.py"
    arch = config["arch"]
    assert (counts.active_body_params(ref, arch),
            counts.decode_flops(ref, arch, 32, 40_000),
            counts.prefill_flops(ref, arch, 1_536),
            counts.paged_attention_bytes(arch, 40_000, 32),
            counts.attention_layers(ref, arch)) == PINNED[name]
