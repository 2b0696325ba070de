"""The port's foundations held to the JAX reference: config, key packing
and comparison, the packed node-image layout (including the reference's
pinned golden schema), and import hygiene of the port."""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.core import keys as jkeys
from repro.core import schema as jschema
from repro_torch.core import config as tconfig
from repro_torch.core import keys as tkeys
from repro_torch.core import schema as tschema
from repro_torch.core.api import WIRE_ENTRY_OVERHEAD, wire_entry_nbytes

ROOT = Path(__file__).resolve().parents[1]
GEOMETRIES = [dict(),
              dict(node_cap=16, log_cap=4, n_shortcuts=4),
              dict(node_cap=32, log_cap=8, n_shortcuts=4, key_words=4,
                   val_words=2)]


def test_layout_matches_pinned_golden():
    golden = json.loads(
        (ROOT / "src/repro/analysis/golden_schema.json").read_text())["detail"]
    layout = tschema.NodeImageLayout(tconfig.HoneycombConfig())
    assert {k: list(v) for k, v in layout.offsets().items()} \
        == golden["image_offsets"]
    assert layout.image_words == golden["image_words"]
    assert layout.log_entry_words == golden["log_entry_words"]
    assert [{"name": f.name, "dims": list(f.dims), "host": f.host,
             "device": f.device, "fill": f.fill}
            for f in tschema.NODE_SCHEMA] == golden["node_schema"]
    assert WIRE_ENTRY_OVERHEAD == golden["wire_entry_overhead"]


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_layout_matches_reference(geometry):
    j = jschema.NodeImageLayout(jconfig.HoneycombConfig(**geometry))
    t = tschema.NodeImageLayout(tconfig.HoneycombConfig(**geometry))
    assert t.offsets() == j.offsets()
    assert (t.image_words, t.log_entry_words, t.node_image_bytes) \
        == (j.image_words, j.log_entry_words, j.node_image_bytes)
    assert tschema.NARROWED_FIELDS == jschema.NARROWED_FIELDS


def test_config_defaults_match_reference():
    t = dataclasses.asdict(tconfig.HoneycombConfig())
    j = dataclasses.asdict(jconfig.HoneycombConfig())
    assert t == {k: j[k] for k in t}
    assert [tconfig.bucket_pow2(n) for n in range(300)] \
        == [jconfig.bucket_pow2(n) for n in range(300)]


def test_pack_unpack_roundtrip_and_view():
    from repro_torch.core.btree import HoneycombTree
    cfg = tconfig.HoneycombConfig(node_cap=16, log_cap=4, n_shortcuts=4)
    tree = HoneycombTree(cfg, heap_capacity=64)
    rng = np.random.default_rng(0)
    for i in rng.permutation(200):
        tree.put(tkeys.int_key(int(i)), b"v%d" % i)
    layout = tschema.NodeImageLayout.for_config(cfg)
    img = layout.pack(tree.heap)
    back = layout.unpack(img)
    for name, slot in layout.slots.items():
        want = getattr(tree.heap, name).astype(slot.spec.device)
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    image = torch.from_numpy(img.view(np.int32))
    for name, slot in layout.slots.items():
        np.testing.assert_array_equal(
            layout.view(image, name).numpy(),
            back[name].view(np.int32), err_msg=name)
    rows = np.array([3, 1, 7], np.int32)
    np.testing.assert_array_equal(layout.pack(tree.heap, rows), img[rows])


def test_key_cmp_twin_matches_reference():
    """torch_key_cmp on int32 bit views == jax_key_cmp on u32 lanes,
    including lanes with the top bit set and prefix ties."""
    rng = np.random.default_rng(1)
    n, kw = 2000, 4
    pool = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x80000001],
                    np.uint32)
    a = pool[rng.integers(0, len(pool), (n, kw))]
    b = a.copy()
    flip = rng.random((n, kw)) < 0.3
    b[flip] = pool[rng.integers(0, len(pool), flip.sum())]
    alen = rng.integers(0, kw * 4 + 1, n).astype(np.int32)
    blen = np.where(rng.random(n) < 0.5, alen,
                    rng.integers(0, kw * 4 + 1, n)).astype(np.int32)
    want = np.asarray(jkeys.jax_key_cmp(jnp.asarray(a), jnp.asarray(alen),
                                        jnp.asarray(b), jnp.asarray(blen)))
    got = tkeys.torch_key_cmp(torch.from_numpy(a.view(np.int32)),
                              torch.from_numpy(alen),
                              torch.from_numpy(b.view(np.int32)),
                              torch.from_numpy(blen)).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    host = [tkeys.key_cmp(a[i], int(alen[i]), b[i], int(blen[i]))
            for i in range(200)]
    np.testing.assert_array_equal(host, want[:200])
    assert tkeys.pack_keys([b"ab", b""], 2)[0].tolist() \
        == jkeys.pack_keys([b"ab", b""], 2)[0].tolist()
    assert wire_entry_nbytes(b"key", b"value") == 5 + 3 + 5


def _imports_of(path: Path) -> list[str]:
    """Top-level module names of every import statement in a file."""
    mods = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module)
    return sorted(set(mods))


def test_port_imports_neither_jax_nor_reference():
    """Importing every module of the port (the training slice's
    ``train``, ``data``, ``distributed`` and ``launch.train`` among
    them), and every module chip_smoke.py and the port's example scripts
    (examples/torch_*.py) import, leaves jax and repro out of
    sys.modules."""
    pkg = ROOT / "src" / "repro_torch"
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py") if p.name != "__init__.py")
    modules += _imports_of(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert {p.name for p in examples} >= {"torch_quickstart.py",
                                          "torch_kv_serving.py",
                                          "torch_train_lm.py"}
    for p in examples:
        modules += _imports_of(p)
    assert "repro_torch.core.shard" in modules and "torch" in modules
    assert "repro_torch.baselines.cpu_store" in modules
    assert "repro_torch.launch.store_dryrun" in modules
    assert "repro_torch.serving.engine" in modules
    assert {"repro_torch.train.optimizer", "repro_torch.train.checkpoint",
            "repro_torch.train.train_loop", "repro_torch.data.pipeline",
            "repro_torch.distributed.compression",
            "repro_torch.launch.train", "repro_torch.compat",
            "repro_torch.launch.mesh", "repro_torch.distributed.sharding",
            "repro_torch.distributed.pipeline",
            "repro_torch.distributed.paged_attention",
            "repro_torch.launch.dryrun",
            "repro_torch.launch.hlo_analysis"} <= set(modules)
    assert {"repro_torch.train.train_loop",
            "repro_torch.configs"} <= set(
        _imports_of(ROOT / "examples" / "torch_train_lm.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
