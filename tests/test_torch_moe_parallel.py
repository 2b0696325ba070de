"""The port's ragged MoE on a mesh held to the JAX reference:
``_ragged_ffn`` (a ``torch.autograd.Function``) and its ragged backward
against ``jax.value_and_grad`` of the reference's custom-VJP
``_ragged_ffn`` (one device, in process), then ``moe_ep_ragged`` (a
generous capacity and one that drops rows) and ``moe_fsliced_ragged`` in a
gloo world of 4 ranks on a (2, 2) ``("data", "model")`` mesh: each output
and the gradients of ``sum(y * ct)`` for x and every parameter against the
reference's on the same mesh (one JAX subprocess with 4 CPU devices,
beside the world) and, where nothing is dropped, against the port's
one-device ``moe_ragged`` and its autograd gradients (the math).

The world and the subprocess come from tests/test_torch_distributed.py's
runner (a ``FileStore`` under ``tmp_path``, a timeout on each); JAX is
imported inside the tests only, since the ranks import this module.

Tolerances (f32): ``_ragged_ffn``'s value and every gradient within 1e-5
of the largest magnitude; the mesh variants' outputs and gradients within
1e-5 of the largest magnitude against the reference (the same f32 ops in
other orders) and against the one-device math.
"""
from __future__ import annotations

import dataclasses
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as me
from repro_torch.models import schema as sc

from test_torch_distributed import rel_err, run_both

TOL = 1e-5
D_MODEL_X = (8, 16)                    # x: [8, 16, d]
VARIANTS = (("ep", "ep_ragged", 8.0),         # no drops
            ("ep_drop", "ep_ragged", 0.5),    # cap 33 of ~64 local rows
            ("fs", "fsliced_ragged", 1.25))


def moe_cfg(cf: float = 1.25):
    return dataclasses.replace(get_smoke_config("olmoe_1b_7b"),
                               capacity_factor=cf)


def moe_inputs() -> dict:
    cfg = moe_cfg()
    rng = np.random.default_rng(0)
    p = sc.map_tree(lambda d: (rng.normal(size=d.shape)
                               / np.sqrt(d.shape[-2])).astype(np.float32),
                    me.moe_schema(cfg))
    inp = {f"p/{k}": v for k, v in p.items()}
    inp["x"] = (rng.normal(size=(*D_MODEL_X, cfg.d_model))
                * 0.5).astype(np.float32)
    inp["ct"] = rng.normal(size=inp["x"].shape).astype(np.float32)
    return inp


def moe_cases(rank: int, inp: dict) -> dict:
    """The torch side: every variant's output and gradients on the mesh,
    and the one-device ``moe_ragged`` with its gradients."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    names = sorted(k[2:] for k in inp if k.startswith("p/"))
    out = {}

    def value_and_grads(fn, prefix):
        p = {k: torch.from_numpy(inp[f"p/{k}"].copy()).requires_grad_(True)
             for k in names}
        x = torch.from_numpy(inp["x"].copy()).requires_grad_(True)
        y = fn(p, x)
        y = y.full_tensor() if hasattr(y, "full_tensor") else y
        grads = torch.autograd.grad((y * torch.from_numpy(inp["ct"])).sum(),
                                    [x] + [p[k] for k in names])
        out[f"{prefix}_y"] = y.detach().numpy()
        out[f"{prefix}_dx"] = grads[0].numpy()
        for k, g in zip(names, grads[1:]):
            out[f"{prefix}_d{k}"] = g.numpy()

    for name, variant, cf in VARIANTS:
        fn = getattr(me, f"moe_{variant}")
        value_and_grads(lambda p, x: fn(p, x, moe_cfg(cf), mesh=mesh,
                                        dp_axes=("data",)), name)
    value_and_grads(lambda p, x: me.moe_ragged(p, x, moe_cfg()), "one")
    return out


REF_SCRIPT = textwrap.dedent(r"""
    import sys, dataclasses
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.launch.mesh import make_mesh
    from repro.models import moe as me

    inp = dict(np.load(sys.argv[1]))
    names = sorted(k[2:] for k in inp if k.startswith("p/"))
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for name, variant, cf in %(variants)r:
        cfg = dataclasses.replace(get_smoke_config("olmoe_1b_7b"),
                                  capacity_factor=cf)
        fn = getattr(me, "moe_" + variant)
        ct = jnp.asarray(inp["ct"])

        def loss(p, x):
            y = fn(p, x, cfg, mesh=mesh, dp_axes=("data",))
            return jnp.sum(y * ct), y
        with mesh:
            p = jax.device_put({k: jnp.asarray(inp["p/" + k]) for k in names},
                               NamedSharding(mesh, P()))
            (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(inp["x"]))
        out[name + "_y"] = np.asarray(y)
        out[name + "_dx"] = np.asarray(gx)
        for k in names:
            out[name + "_d" + k] = np.asarray(gp[k])
    np.savez(sys.argv[2], **out)
""") % dict(variants=VARIANTS)


@pytest.fixture(scope="module")
def moe_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    inputs = moe_inputs()
    ranks, ref = run_both(tmp, inputs, f"{__name__}:moe_cases", REF_SCRIPT)
    return inputs, ranks, ref


def _ragged_case(rng, sizes, m, d=24, f=40, dtype=np.float32):
    E = len(sizes)
    xs = rng.normal(size=(m, d)).astype(dtype)
    ws = [(rng.normal(size=s) / np.sqrt(s[-2])).astype(dtype)
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    dy = rng.normal(size=(m, d)).astype(dtype)
    return xs, ws, dy, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("sizes,m", [
    ((5, 0, 7, 3), 15),            # an empty group
    ((4, 4, 4, 4, 4, 4), 24),
    ((0, 9, 0, 2), 14),            # rows past the groups (as ep's cap)
])
def test_ragged_ffn_value_and_grads_match_reference(sizes, m):
    """``_ragged_ffn`` forward and its ragged backward (dX through the
    transposed weights per group, dW per-group outer products) against
    ``jax.value_and_grad`` of the reference's ``_ragged_ffn`` on the same
    f32 inputs; rows past the groups give zero outputs and gradients."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jme
    xs, ws, dy, gs = _ragged_case(np.random.default_rng(sum(sizes)), sizes,
                                  m)

    def jloss(xs, wg, wu, wd):
        return jnp.sum(jme._ragged_ffn(xs, wg, wu, wd, jnp.asarray(gs)) * dy)
    jy = jme._ragged_ffn(jnp.asarray(xs), *map(jnp.asarray, ws),
                         jnp.asarray(gs))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(xs), *map(jnp.asarray, ws))
    tin = [torch.from_numpy(a).requires_grad_(True) for a in (xs, *ws)]
    ty = me._ragged_ffn(*tin, torch.from_numpy(gs))
    tgrads = torch.autograd.grad((ty * torch.from_numpy(dy)).sum(), tin)
    assert rel_err(jy, ty.detach().numpy()) <= TOL
    for a, b in zip(jgrads, tgrads):
        assert rel_err(a, b.numpy()) <= TOL
    past = int(np.sum(gs))
    assert not ty[past:].any() and not tgrads[0][past:].any()


def test_ragged_ffn_backward_is_ragged():
    """The backward runs the reference's ragged terms and nothing dense:
    it equals autograd through the per-group products of ``moe_ragged``'s
    loop (each group's rows times its expert's weights)."""
    rng = np.random.default_rng(7)
    xs, ws, dy, gs = _ragged_case(rng, (3, 0, 6, 2), 11)
    a = [torch.from_numpy(v).requires_grad_(True) for v in (xs, *ws)]
    y = me._ragged_ffn(*a, gs.tolist())
    ga = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), a)
    b = [torch.from_numpy(v).requires_grad_(True) for v in (xs, *ws)]
    rows, lo = [], 0
    for e, n in enumerate(gs.tolist()):
        h = torch.nn.functional.silu(b[0][lo:lo + n] @ b[1][e]) \
            * (b[0][lo:lo + n] @ b[2][e])
        rows.append(h @ b[3][e])
        lo += n
    gb = torch.autograd.grad((torch.cat(rows) * torch.from_numpy(dy)).sum(),
                             b)
    assert rel_err(y.detach().numpy(), torch.cat(rows).detach().numpy()) \
        <= TOL
    for u, v in zip(ga, gb):
        assert rel_err(v.numpy(), u.numpy()) <= TOL


@pytest.mark.parametrize("name", [v[0] for v in VARIANTS])
def test_mesh_moe_matches_reference(moe_run, name):
    """Each variant's output and its gradients for x and every parameter
    on the (2, 2) mesh against the reference's on the same mesh; every
    rank holds the same values."""
    _, ranks, ref = moe_run
    keys = [f"{name}_{s}" for s in ("y", "dx", "drouter", "dw_down",
                                    "dw_gate", "dw_up")]
    for k in keys:
        assert rel_err(ref[k], ranks[0][k]) <= TOL, k
        for r in ranks[1:]:
            assert np.array_equal(r[k], ranks[0][k]), k


@pytest.mark.parametrize("name", ["ep", "fs"])
def test_mesh_moe_matches_one_device_math(moe_run, name):
    """Where no row is dropped, the mesh variants' outputs and gradients
    equal the one-device ``moe_ragged``'s (autograd through its group
    loop): the reductions over each mesh axis neither drop nor double a
    term, in the reference as in the port."""
    _, ranks, ref = moe_run
    got = ranks[0]
    for k in (k for k in got if k.startswith("one_")):
        want = got[k]
        assert rel_err(want, got[k.replace("one_", f"{name}_")]) <= TOL, k
        assert rel_err(want, ref[k.replace("one_", f"{name}_")]) <= TOL, k


def test_ep_capacity_drops_rows(moe_run):
    """At capacity factor 0.5 each rank keeps 33 of its ~64 local routed
    rows: the output differs from the no-drop one, and both packages drop
    the same rows."""
    _, ranks, ref = moe_run
    assert rel_err(ref["ep_y"], ref["ep_drop_y"]) > 0.1
    assert rel_err(ref["ep_drop_y"], ranks[0]["ep_drop_y"]) <= TOL
