"""The port's mesh layer held to the JAX reference: logical axes, the
sharding rules and every leaf's placements (fake meshes, all ten configs),
``compat``'s spec placements, ``launch/mesh.py``, and, in a gloo world of
4 ranks, ``paged_attention_local`` (KV heads split, head_dim split),
``pipeline_apply`` over 4 stages, ``build_step``'s train step (``dense``
on qwen-smoke, ``fsliced`` and ``ep_ragged`` on olmoe-smoke), its prefill
and its decode step under ``decode_impl="local"`` and ``"gather"``.

The reference's mesh outputs come from one JAX subprocess per module
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, the same (2, 2)
and (4,) meshes), started beside the torch world; both read one ``.npz``
of inputs made from a seed, and write theirs.  The world's ranks are
spawned processes, rendezvous through a ``FileStore`` under ``tmp_path``;
the world and the subprocess each have a timeout and fail when it
passes.  JAX is imported only inside the tests: the spawned ranks import
this module and must not load it.

Tolerances (f32 throughout): attention outputs and pools within 1e-5 of
the largest magnitude (the same f32 ops, other sum orders; the pools'
untouched pages bit for bit); the pipeline within 1e-5; the train step's
loss and gnorm within 1e-5 relative, every parameter leaf and every
first moment within 1e-4 of the leaf's largest magnitude (the gradients
pass two frameworks' backward passes, as in tests/test_torch_train.py);
decode logits within 1e-5 of the largest magnitude.
"""
from __future__ import annotations

import dataclasses
import importlib
import multiprocessing
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.compat import PartitionSpec as P, placements
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import schema as sc
from repro_torch.models import transformer as tf
from repro_torch.models.config import ShapeConfig

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 240        # seconds for a spawned world to finish
JAX_TIMEOUT = 240          # seconds for a reference subprocess
OUT_TOL = 1e-5
STEP_TOL = 1e-4

TRAIN_SHAPE = dict(seq_len=16, global_batch=8, page_size=8)
TRAIN_CASES = (("qwen_dense", "qwen2p5_3b", "dense"),
               ("olmoe_fsliced", "olmoe_1b_7b", "fsliced"))
DEC = dict(B=8, S=32, P=8)
PA = dict(B=8, H=4, KVH=2, D=16, P=8, PPS=4)


# ------------------------------------------------------------- the world
def flat(tree, prefix: str) -> dict:
    """A nested dict of arrays as {"prefix/a/b": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def nest(arrays: dict, prefix: str) -> dict:
    """``flat``'s inverse for the keys under ``prefix``."""
    out: dict = {}
    for key, v in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def _rank_main(rank, world, store, target, in_path, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        inputs = dict(np.load(in_path))
        out = fn(rank, inputs)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def start_world(target: str, world: int, tmp: Path, in_path: Path):
    """Spawn ``world`` ranks running ``target`` ("module:function",
    ``fn(rank, inputs) -> {name: array}``) in a gloo world."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(tmp / "store"), target,
                               str(in_path), str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_world(procs, tmp: Path, timeout: float) -> list[dict]:
    """Every rank's outputs; fails if a rank fails or the world outlives
    ``timeout`` (then every rank is killed)."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 0.1))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(timeout=10)
    assert not alive, f"the world did not finish in {timeout} s"
    assert all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(len(procs))]


def start_jax(script: str, in_path: Path, out_path: Path, devices: int):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-c", script, str(in_path), str(out_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def join_jax(proc, out_path: Path, timeout: float) -> dict:
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"the reference did not finish in {timeout} s")
    assert proc.returncode == 0, err[-3000:]
    return dict(np.load(out_path))


def run_both(tmp: Path, inputs: dict, target: str, script: str) -> tuple:
    """The torch world (4 ranks) and the reference subprocess (4 CPU
    devices) on the same inputs, side by side: (rank outputs, reference
    outputs)."""
    in_path = tmp / "inputs.npz"
    np.savez(in_path, **inputs)
    jax_proc = start_jax(script, in_path, tmp / "ref.npz", 4)
    try:
        ranks = join_world(start_world(target, 4, tmp, in_path), tmp,
                           WORLD_TIMEOUT)
    finally:
        ref = join_jax(jax_proc, tmp / "ref.npz", JAX_TIMEOUT)
    return ranks, ref


def rel_err(want, got) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(want - np.asarray(got, np.float64)).max()
                 / max(float(np.abs(want).max()), 1e-30))


def f32_params(arch: str, seed: int) -> dict:
    """A smoke config's parameters in f32 from a seed, as numpy; every
    leaf drawn (no zero biases: AdamW's first update of a zero leaf is
    +-lr wherever its gradient is not tiny, and the leaf would hold
    nothing else)."""
    cfg = get_smoke_config(arch)
    schema = sc.map_tree(lambda d: dataclasses.replace(
        d, dtype=torch.float32, init="normal"), tf.schema(cfg))
    return sc.map_tree(lambda t: t.numpy(), sc.init(
        schema, torch.Generator().manual_seed(seed), "cpu"))


# ------------------------------------------------------ the world's cases
def _tensors(tree):
    """Copies: a placed replicated leaf keeps its tensor's storage, and a
    step updates it in place."""
    return sc.map_tree(lambda a: torch.from_numpy(a.copy()), tree)


def _place(mesh, tree, pl_tree):
    return sc.place(_tensors(tree), pl_tree, mesh)


def _full(x) -> np.ndarray:
    return x.full_tensor().detach().numpy()


def mesh_cases(rank: int, inp: dict) -> dict:
    """The torch side of this module's mesh cases, on every rank."""
    from repro_torch.distributed.paged_attention import paged_attention_local
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import optimizer as opt
    t = torch.from_numpy
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for name, kv_axis, hd_axis in (("kv", "model", None),
                                   ("hd", None, "model")):
        o, kp, vp = paged_attention_local(
            t(inp["pa_q"]), t(inp["pa_kp"]).clone(), t(inp["pa_vp"]).clone(),
            t(inp["pa_bt"]), t(inp["pa_lens"]), t(inp["pa_start"]),
            t(inp["pa_kn"]), t(inp["pa_vn"]), mesh=mesh,
            batch_axes=("data",), kv_head_axis=kv_axis,
            head_dim_axis=hd_axis, page_size=PA["P"],
            scale=PA["D"] ** -0.5)
        out[f"pa_{name}_out"] = _full(o)
        out[f"pa_{name}_kp"] = _full(kp)
        out[f"pa_{name}_vp"] = _full(vp)

    stages = make_mesh((4,), ("stage",), "cpu")
    out["pipe"] = _full(pipeline_apply(
        lambda p, x: torch.tanh(x @ p["w"]), {"w": t(inp["pipe_w"])},
        t(inp["pipe_x"]), mesh=stages, stage_axis="stage"))

    batch = {"tokens": t(inp["train_tokens"]),
             "labels": t(inp["train_labels"])}
    ocfg = opt.AdamWConfig(warmup_steps=1)
    shape = ShapeConfig("t", "train", **TRAIN_SHAPE)
    for name, arch, impl in TRAIN_CASES + (("olmoe_ep", "olmoe_1b_7b",
                                            "ep_ragged"),):
        cfg = get_smoke_config(arch)
        policy = ShardingPolicy(expert_parallel=impl == "ep_ragged")
        if impl == "ep_ragged":      # no drops: the one-device math holds
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        built = steps.build_step(cfg, shape, mesh, policy=policy,
                                 moe_impl=impl, opt_cfg=ocfg, grad_accum=2)
        params = _place(mesh, nest(inp, arch), built.in_shardings[0])
        state = opt.init(params)
        placed = {k: sc.place({"x": v}, {"x": built.in_shardings[2][k]},
                              mesh)["x"] for k, v in batch.items()}
        params, state, m = built.fn(params, state, placed)
        out[f"{name}_loss"] = m["loss"].detach().numpy()
        out[f"{name}_gnorm"] = m["gnorm"].detach().numpy()
        out[f"{name}_step"] = state.step.numpy()
        out.update(flat(sc.map_tree(_full, params), f"{name}_params"))
        out.update(flat(sc.map_tree(_full, state.mu), f"{name}_mu"))
        if impl != "dense":          # the one-device port from the same
            one = _tensors(nest(inp, arch))           # numbers (the math)
            one, ost, om = steps.train_step(
                one, opt.init(one), batch, cfg, ocfg, accum=2,
                moe_impl="ragged")
            out.update(flat(sc.map_tree(lambda x: x.detach().numpy(), one),
                            f"{name}_one"))
            out[f"{name}_one_loss"] = om["loss"].numpy()

    cfg = get_smoke_config("qwen2p5_3b")
    pre = ShapeConfig("p", "prefill", seq_len=16, global_batch=DEC["B"],
                      page_size=DEC["P"])
    built = steps.build_step(cfg, pre, mesh)
    params = _place(mesh, nest(inp, "qwen2p5_3b"), built.in_shardings[0])
    tokens = sc.place({"x": t(inp["train_tokens"])},
                      {"x": built.in_shardings[1]["tokens"]}, mesh)["x"]
    logits, cache = built.fn(params, {"tokens": tokens})
    out["pre_logits"] = _full(logits)
    out["pre_bt"] = _full(cache.block_tables)
    out.update(flat(sc.map_tree(_full, cache.layers), "pre_cache"))

    dec = ShapeConfig("d", "decode", seq_len=DEC["S"], global_batch=DEC["B"],
                      page_size=DEC["P"])
    for impl in ("local", "gather"):
        built = steps.build_step(cfg, dec, mesh,
                                 policy=ShardingPolicy(decode_impl=impl))
        csh = built.in_shardings[1]
        cache = tf.DecodeCache(
            _place(mesh, nest(inp, "dec_cache"), csh.layers),
            sc.place({"x": t(inp["dec_bt"])}, {"x": csh.block_tables},
                     mesh)["x"],
            sc.place({"x": t(inp["dec_lens"])}, {"x": csh.seq_lens},
                     mesh)["x"])
        tokens = sc.place({"x": t(inp["dec_tokens"])},
                          {"x": built.in_shardings[2]}, mesh)["x"]
        logits, cache = built.fn(params, cache, tokens)
        out[f"dec_{impl}_logits"] = _full(logits)
        out[f"dec_{impl}_lens"] = _full(cache.seq_lens)
        out.update(flat(sc.map_tree(_full, cache.layers),
                        f"dec_{impl}_cache"))
    return out


REF_SCRIPT = textwrap.dedent(r"""
    import sys, dataclasses
    import numpy as np, jax, jax.numpy as jnp
    import repro.core  # noqa: F401  (before repro.kernels)
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.distributed.paged_attention import paged_attention_local
    from repro.distributed.pipeline import pipeline_apply
    from repro.distributed.sharding import ShardingPolicy
    from repro.launch import steps
    from repro.launch.mesh import make_mesh
    from repro.models import transformer as tf
    from repro.models.config import ShapeConfig
    from repro.train import optimizer as opt

    inp = dict(np.load(sys.argv[1]))
    SHAPE, DEC, PA = %(shape)r, %(dec)r, %(pa)r

    def nest(prefix):
        out = {}
        for key, v in inp.items():
            if key.startswith(prefix + "/"):
                *path, leaf = key[len(prefix) + 1:].split("/")
                d = out
                for p in path:
                    d = d.setdefault(p, {})
                d[leaf] = jnp.asarray(v)
        return out

    def flat(tree, prefix, out):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, prefix + "/" + k, out)
            else:
                out[prefix + "/" + k] = np.asarray(v)

    out = {}
    mesh = make_mesh((2, 2), ("data", "model"))
    for name, kv, hd in (("kv", "model", None), ("hd", None, "model")):
        with mesh:
            o, kp, vp = jax.jit(lambda *a: paged_attention_local(
                *a, mesh=mesh, batch_axes=("data",), kv_head_axis=kv,
                head_dim_axis=hd, page_size=PA["P"],
                scale=PA["D"] ** -0.5))(
                *(jnp.asarray(inp["pa_" + k]) for k in
                  ("q", "kp", "vp", "bt", "lens", "start", "kn", "vn")))
        out["pa_%%s_out" %% name] = np.asarray(o)
        out["pa_%%s_kp" %% name] = np.asarray(kp)
        out["pa_%%s_vp" %% name] = np.asarray(vp)

    stages = make_mesh((4,), ("stage",))
    with stages:
        w = jax.device_put(jnp.asarray(inp["pipe_w"]),
                           NamedSharding(stages, P("stage")))
        out["pipe"] = np.asarray(jax.jit(lambda w, x: pipeline_apply(
            lambda p, x: jnp.tanh(x @ p), w, x, mesh=stages,
            stage_axis="stage"))(w, jnp.asarray(inp["pipe_x"])))

    shape = ShapeConfig("t", "train", **SHAPE)
    ocfg = opt.AdamWConfig(warmup_steps=1)
    batch = {"tokens": jnp.asarray(inp["train_tokens"]),
             "labels": jnp.asarray(inp["train_labels"])}
    for name, arch, impl in %(train)r:
        cfg = get_smoke_config(arch)
        built = steps.build_step(cfg, shape, mesh, moe_impl=impl,
                                 opt_cfg=ocfg, grad_accum=2)
        with mesh:
            params = jax.device_put(nest(arch), built.in_shardings[0])
            state = jax.device_put(opt.init(params), built.in_shardings[1])
            b = jax.device_put(batch, built.in_shardings[2])
            params, state, m = jax.jit(
                built.fn, in_shardings=built.in_shardings,
                out_shardings=built.out_shardings)(params, state, b)
        out[name + "_loss"] = np.asarray(m["loss"])
        out[name + "_gnorm"] = np.asarray(m["gnorm"])
        out[name + "_step"] = np.asarray(state.step)
        flat(params, name + "_params", out)
        flat(state.mu, name + "_mu", out)

    cfg = get_smoke_config("qwen2p5_3b")
    dec = ShapeConfig("d", "decode", seq_len=DEC["S"],
                      global_batch=DEC["B"], page_size=DEC["P"])
    built = steps.build_step(cfg, dec, mesh,
                             policy=ShardingPolicy(decode_impl="local"))
    cache = tf.DecodeCache(nest("dec_cache"), jnp.asarray(inp["dec_bt"]),
                           jnp.asarray(inp["dec_lens"]))
    with mesh:
        args = jax.device_put((nest("qwen2p5_3b"), cache,
                               jnp.asarray(inp["dec_tokens"])),
                              built.in_shardings)
        logits, cache = jax.jit(built.fn, in_shardings=built.in_shardings,
                                out_shardings=built.out_shardings)(*args)
    out["dec_logits"] = np.asarray(logits)
    flat(cache.layers, "dec_cache", out)
    np.savez(sys.argv[2], **out)
""") % dict(shape=TRAIN_SHAPE, dec=DEC, pa=PA, train=TRAIN_CASES)


def mesh_inputs() -> dict:
    rng = np.random.default_rng(0)
    B, H, KVH, D, P_, PPS = (PA[k] for k in ("B", "H", "KVH", "D", "P",
                                             "PPS"))
    NP = B * PPS
    inp = {"pa_q": rng.normal(size=(B, H, D)),
           "pa_kp": rng.normal(size=(NP, P_, KVH, D)),
           "pa_vp": rng.normal(size=(NP, P_, KVH, D)),
           "pa_kn": rng.normal(size=(B, KVH, D)),
           "pa_vn": rng.normal(size=(B, KVH, D)),
           "pipe_w": rng.normal(size=(4, 16, 16)) * 0.3,
           "pipe_x": rng.normal(size=(6, 2, 16))}
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    inp["pa_bt"] = np.arange(NP, dtype=np.int32).reshape(B, PPS)
    inp["pa_lens"] = rng.integers(1, P_ * PPS - 1, B).astype(np.int32)
    inp["pa_start"] = np.zeros(B, np.int32)
    inp["pa_start"][::3] = 2           # a window start past 0 on some rows
    for arch in ("qwen2p5_3b", "olmoe_1b_7b"):
        inp.update(flat(f32_params(arch, 1), arch))
    Bt, S = TRAIN_SHAPE["global_batch"], TRAIN_SHAPE["seq_len"]
    inp["train_tokens"] = rng.integers(0, 256, (Bt, S)).astype(np.int32)
    inp["train_labels"] = rng.integers(0, 256, (Bt, S)).astype(np.int32)
    inp["train_labels"][0, :5] = -1    # uneven label counts over the rows
    cfg = get_smoke_config("qwen2p5_3b")
    from repro_torch.launch import steps
    dec = ShapeConfig("d", "decode", seq_len=DEC["S"], global_batch=DEC["B"],
                      page_size=DEC["P"])
    inp.update(flat(sc.map_tree(
        lambda s: rng.normal(size=s.shape).astype(np.float32),
        steps.decode_cache_abstract(cfg, dec).layers), "dec_cache"))
    inp["dec_bt"] = np.arange(DEC["B"] * DEC["S"] // DEC["P"],
                              dtype=np.int32).reshape(DEC["B"], -1)
    inp["dec_lens"] = rng.integers(1, DEC["S"] - 1, DEC["B"]).astype(np.int32)
    inp["dec_tokens"] = rng.integers(0, 256, (DEC["B"], 1)).astype(np.int32)
    return inp


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    inputs = mesh_inputs()
    ranks, ref = run_both(tmp, inputs, f"{__name__}:mesh_cases", REF_SCRIPT)
    return inputs, ranks, ref


# ------------------------------------------------------------------ tests
class _FakeMesh:
    """The rules read only axis names and sizes; both packages' stand-ins
    (the reference's reads ``axis_names``/``devices.shape``, as
    tests/test_distributed.py's ``_FakeMesh``)."""

    def __init__(self, shape, names):
        self.mesh_dim_names = self.axis_names = names
        self.shape = shape
        self.devices = np.zeros(shape)


FAKE_MESHES = (((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")),
               ((2, 2), ("data", "model")))


def _ref_placements(spec, names) -> tuple:
    """The placements a JAX PartitionSpec means, written out by hand."""
    from torch.distributed.tensor import Replicate, Shard
    dims = {}
    for d, entry in enumerate(spec):
        for a in (() if entry is None else (entry,) if isinstance(entry, str)
                  else entry):
            dims[a] = d
    return tuple(Shard(dims[n]) if n in dims else Replicate() for n in names)


def _leaves(tree) -> list:
    """A dict tree's leaves in sorted-key order (a placement tuple is one
    leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _cache_schema(tfm, cfg):
    return tfm.layer_cache_schema(cfg, 8, 4, 16)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_and_placements_match_reference(arch):
    """Every ParamDef's logical axes (parameters and the layer caches,
    stacked) equal the reference's, and on 16 x 16, 2 x 16 x 16 and 2 x 2
    fake meshes the rules and every leaf's placements equal the
    reference's specs, for train_4k and decode_32k."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.distributed.sharding import make_rules as jmake_rules
    from repro.distributed.sharding import ShardingPolicy as JPolicy
    from repro.models import schema as jsc
    from repro.models import transformer as jtf
    from repro.models.config import shape_by_name as jshape
    from repro_torch.distributed.sharding import ShardingPolicy, make_rules
    from repro_torch.models.config import shape_by_name
    cfg, jcfg = get_config(arch), jget_config(arch)
    trees = {"params": (tf.schema(cfg), jtf.schema(jcfg)),
             "cache": (sc.stack(cfg.n_superblocks, _cache_schema(tf, cfg)),
                       jsc.stack(jcfg.n_superblocks,
                                 _cache_schema(jtf, jcfg)))}
    for name, (tree, jtree) in trees.items():
        leaves = sc.flatten(tree)
        jleaves = jax.tree.leaves(jtree, is_leaf=lambda x: isinstance(
            x, jsc.ParamDef))
        assert [(d.shape, d.axes) for d in leaves] == \
            [(d.shape, d.axes) for d in jleaves], name
    for shape_name in ("train_4k", "decode_32k"):
        for mshape, names in FAKE_MESHES:
            mesh = _FakeMesh(mshape, names)
            for ep in (False, True):
                rules = make_rules(cfg, mesh, shape_by_name(shape_name),
                                   ShardingPolicy(expert_parallel=ep))
                jrules = jmake_rules(jcfg, mesh, jshape(shape_name),
                                     JPolicy(expert_parallel=ep))
                assert rules == jrules
                for tree, jtree in trees.values():
                    got = _leaves(sc.shardings(tree, rules, mesh))
                    specs = jsc.to_mesh_specs(jsc.logical_specs(jtree),
                                              jrules)
                    want = [_ref_placements(s, names)
                            for s in jax.tree.leaves(
                                specs, is_leaf=lambda x: isinstance(
                                    x, jax.sharding.PartitionSpec))]
                    assert len(got) == len(want)
                    assert all(tuple(g) == w for g, w in zip(got, want))


def test_spec_placements_follow_mesh_order():
    """A tuple entry is split major to minor in mesh order (DTensor's and
    JAX's order agree); another order, an unknown axis or an axis used
    twice raises."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _FakeMesh((2, 4, 4), ("pod", "data", "model"))
    assert placements(P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements(P(), mesh) == (Replicate(),) * 3
    for bad in (P(("data", "pod")), P("x"), P("data", "data")):
        with pytest.raises(ValueError):
            placements(bad, mesh)


def test_mesh_module_touches_no_process_group():
    """Importing ``launch/mesh.py`` initialises nothing; the production
    mesh raises outside a world of 256 (512) ranks; ``bubble_fraction``
    is the reference's."""
    import torch.distributed as dist
    from repro_torch.distributed.pipeline import bubble_fraction
    from repro_torch.launch import mesh as tmesh
    importlib.reload(tmesh)
    assert not dist.is_initialized()
    for multi_pod in (False, True):
        with pytest.raises(RuntimeError):
            tmesh.make_production_mesh(multi_pod=multi_pod)
    assert abs(bubble_fraction(6, 4) - 3 / 9) < 1e-12


def test_paged_attention_local_matches_reference(mesh_run):
    """KV heads split and head_dim split on a (2, 2) mesh, some windows
    starting past 0: the output and both pools against the reference's
    ``paged_attention_local`` on the same mesh; every rank agrees."""
    inputs, ranks, ref = mesh_run
    for name in ("kv", "hd"):
        for part in ("out", "kp", "vp"):
            key = f"pa_{name}_{part}"
            assert rel_err(ref[key], ranks[0][key]) <= OUT_TOL, key
            assert all(np.array_equal(r[key], ranks[0][key])
                       for r in ranks[1:])
        written = ~np.isclose(inputs["pa_kp"], ref[f"pa_{name}_kp"])
        assert written.any(axis=(1, 2, 3)).sum() == PA["B"]
        assert np.array_equal(ranks[0][f"pa_{name}_kp"][~written],
                              inputs["pa_kp"][~written])


def test_pipeline_four_stages_matches_reference(mesh_run):
    """``pipeline_apply`` over 4 stages (6 microbatches) against the
    reference's and against the stages run in sequence."""
    inputs, ranks, ref = mesh_run
    x = inputs["pipe_x"]
    for s in range(4):
        x = np.tanh(x @ inputs["pipe_w"][s])
    assert rel_err(ref["pipe"], ranks[0]["pipe"]) <= OUT_TOL
    assert rel_err(x, ranks[0]["pipe"]) <= OUT_TOL


@pytest.mark.parametrize("name", [c[0] for c in TRAIN_CASES])
def test_build_step_train_matches_reference(mesh_run, name):
    """One ``build_step`` train step on a (2, 2) mesh (8 x 16 tokens, 2
    microbatches, labels with -1s) against the reference's on the same
    mesh from the same f32 parameters: loss, gnorm, step, every parameter
    leaf and every first moment."""
    _, ranks, ref = mesh_run
    got = ranks[0]
    for k in ("loss", "gnorm"):
        assert rel_err(ref[f"{name}_{k}"], got[f"{name}_{k}"]) <= OUT_TOL
    assert int(got[f"{name}_step"]) == int(ref[f"{name}_step"]) == 1
    for part in ("params", "mu"):
        keys = [k for k in ref if k.startswith(f"{name}_{part}/")]
        assert keys and sorted(keys) == sorted(
            k for k in got if k.startswith(f"{name}_{part}/"))
        for k in keys:
            assert rel_err(ref[k], got[k]) <= STEP_TOL, k
    for r in ranks[1:]:
        assert float(r[f"{name}_loss"]) == float(got[f"{name}_loss"])


@pytest.mark.parametrize("name", ["olmoe_fsliced", "olmoe_ep"])
def test_build_step_ragged_moe_matches_one_device(mesh_run, name):
    """The ``fsliced`` and ``ep_ragged`` (no drops) train steps on the mesh
    against the port's one-device ``train_step(moe_impl="ragged")`` from
    the same numbers: the gradient reductions over each axis give the
    one-device values."""
    _, ranks, _ = mesh_run
    got = ranks[0]
    assert rel_err(got[f"{name}_one_loss"], got[f"{name}_loss"]) <= OUT_TOL
    keys = [k for k in got if k.startswith(f"{name}_one/")]
    assert keys
    for k in keys:
        want = got[k]
        assert rel_err(want, got[k.replace("_one/", "_params/")]) \
            <= STEP_TOL, k


def test_build_step_prefill_matches_reference(mesh_run):
    """``build_step``'s prefill on the (2, 2) mesh against the reference's
    one-device ``prefill``: logits, every KV page, and block tables of
    global page ids."""
    import jax.numpy as jnp
    import repro.core  # noqa: F401  (before repro.kernels)
    from repro.configs import get_smoke_config as jget_smoke
    from repro.models import transformer as jtf
    inputs, ranks, _ = mesh_run
    params = nest({k: jnp.asarray(v) for k, v in inputs.items()},
                  "qwen2p5_3b")
    logits, cache = jtf.prefill(params, jget_smoke("qwen2p5_3b"),
                                tokens=jnp.asarray(inputs["train_tokens"]),
                                page_size=DEC["P"])
    got = ranks[0]
    assert rel_err(logits, got["pre_logits"]) <= OUT_TOL
    assert np.array_equal(np.asarray(cache.block_tables), got["pre_bt"])
    for k, v in flat(cache.layers, "pre_cache").items():
        assert rel_err(v, got[k]) <= OUT_TOL, k


def test_build_step_decode_local_matches_reference(mesh_run):
    """One decode step (qwen-smoke, 8 sequences in pools of 32 positions,
    pages of 8) on the (2, 2) mesh under ``decode_impl="local"`` against
    the reference's on the same mesh: logits and every pool; ``"gather"``
    gives the same logits and pools; lengths advance by one."""
    inputs, ranks, ref = mesh_run
    got = ranks[0]
    for impl in ("local", "gather"):
        assert rel_err(ref["dec_logits"], got[f"dec_{impl}_logits"]) \
            <= OUT_TOL, impl
        assert np.array_equal(got[f"dec_{impl}_lens"],
                              inputs["dec_lens"] + 1)
        for k in (k for k in ref if k.startswith("dec_cache/")):
            assert rel_err(ref[k], got[k.replace(
                "dec_cache", f"dec_{impl}_cache")]) <= OUT_TOL, k
    assert np.array_equal(got["dec_local_logits"], got["dec_gather_logits"])
