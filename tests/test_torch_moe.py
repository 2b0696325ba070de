"""The port's MoE FFN (``repro_torch.models.moe``) held to the JAX
reference's on the reference's own parameters, carried over by
``schema.from_numpy``, at the olmoe, mixtral and jamba smoke configs.

The dense and the ragged implementations round at other steps in bf16
and may route a near-tied token to another expert, so each is held to
the reference's same implementation; the port's two are held to each
other in f32 only.  The grouped MoE of prefill (its plain version here;
the kernels in tests/test_torch_cuda.py) rounds as the dense one does, so
in bf16 it is held to the reference's dense MoE, in f32 to both.

Tolerances: the router's top-k weights within 1e-5 in f32 (softmax of
f32 logits, the frameworks sum in other orders); the FFN output 1e-5
(rtol and atol) with f32 parameters and inputs; ``BF16_TOL`` with the
bf16 parameters as drawn, compared only where both frameworks picked the
same top-k experts (a flip moves a token's output by a whole expert's
share).  Inputs are made from a seed with numpy."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: breaks an import cycle)
from repro.configs import get_smoke_config as jget_smoke
from repro.models import moe as jme
from repro.models import schema as jsc
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import moe_grouped as kmg
from repro_torch.kernels import ops as kops
from repro_torch.models import moe as tme
from repro_torch.models import schema as tsc

F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 keeps 8 mantissa bits: outputs of magnitude ~1 round to 2**-8, and
# the frameworks round the activations at other steps
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
ARCHS = ("olmoe_1b_7b", "mixtral_8x22b", "jamba_v0p1_52b")


def moe_params(arch, dtype=np.float32, seed=0):
    """The reference's initial MoE parameters for the smoke config: (jax
    tree, port tree), cast to ``dtype`` unless it is None (as drawn)."""
    cfg = jget_smoke(arch)
    params = jsc.init(jme.moe_schema(cfg), jax.random.key(seed))
    npt = jax.tree.map(np.asarray, params)
    if dtype is not None:
        npt = jax.tree.map(lambda a: a.astype(dtype), npt)
    return jax.tree.map(jnp.asarray, npt), tsc.from_numpy(npt)


def _x(cfg, shape, dtype, seed=1):
    x = np.random.default_rng(seed).normal(size=(*shape, cfg.d_model)) \
        .astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype is None else jnp.float32)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype is None else torch.float32)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_router_probs_match_reference(arch):
    cfg = get_smoke_config(arch)
    jp, tp = moe_params(arch)
    jx, tx = _x(cfg, (3, 7), np.float32)
    wp, wi = jme.router_probs(jp, jx, jget_smoke(arch))
    gp, gi = tme.router_probs(tp, tx, cfg)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(_np(gp), np.asarray(wp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(gp.sum(-1)), 1.0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", ["dense", "ragged"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(2, 9), (5, 1)])
def test_moe_matches_reference_f32(arch, impl, shape):
    """A prefill batch and a decode batch (one token a row)."""
    cfg = get_smoke_config(arch)
    jp, tp = moe_params(arch)
    jx, tx = _x(cfg, shape, np.float32)
    want = jme.moe(jp, jx, jget_smoke(arch), impl=impl)
    got = tme.moe(tp, tx, cfg, impl=impl)
    assert got.dtype == torch.float32 and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("impl", ["dense", "ragged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_reference_bf16_where_routed_alike(arch, impl):
    cfg = get_smoke_config(arch)
    jp, tp = moe_params(arch, dtype=None)
    jx, tx = _x(cfg, (3, 16), None)
    _, wi = jme.router_probs(jp, jx, jget_smoke(arch))
    _, gi = tme.router_probs(tp, tx, cfg)
    same = (np.sort(gi.numpy(), -1) == np.sort(np.asarray(wi), -1)).all(-1)
    assert same.mean() > 0.9
    want = np.asarray(jme.moe(jp, jx, jget_smoke(arch), impl=impl),
                      np.float32)
    got = tme.moe(tp, tx, cfg, impl=impl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got)[same], want[same], **BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_equals_ragged_in_f32(arch):
    cfg = get_smoke_config(arch)
    _, tp = moe_params(arch, seed=2)
    _, tx = _x(cfg, (4, 11), np.float32, seed=3)
    torch.testing.assert_close(tme.moe_dense(tp, tx, cfg),
                               tme.moe_ragged(tp, tx, cfg), **F32_TOL)


def test_moe_impl_dispatch_and_flops():
    cfg = get_smoke_config("olmoe_1b_7b")
    _, tp = moe_params("olmoe_1b_7b")
    _, tx = _x(cfg, (1, 4), np.float32)
    assert torch.equal(tme.moe(tp, tx, cfg), tme.moe_dense(tp, tx, cfg))
    assert torch.equal(tme.moe(tp, tx, cfg, impl=tme.moe_ragged),
                       tme.moe_ragged(tp, tx, cfg))
    for arch in ARCHS:
        full = get_config(arch)
        for active in (True, False):
            assert tme.moe_flops_per_token(full, active) == \
                jme.moe_flops_per_token(full, active)
    assert tme.moe_flops_per_token(get_config("olmoe_1b_7b")) == \
        6 * 2048 * 1024 * 8


# --- the grouped MoE of prefill -------------------------------------------
@pytest.mark.parametrize("ref_impl", ["dense", "ragged"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(2, 9), (1, 1)])
def test_moe_grouped_matches_reference_f32(arch, ref_impl, shape):
    """The grouped MoE's plain version (the CPU's path) against the
    reference's dense and ragged MoE with f32 parameters and inputs."""
    cfg = get_smoke_config(arch)
    jp, tp = moe_params(arch)
    jx, tx = _x(cfg, shape, np.float32)
    want = jme.moe(jp, jx, jget_smoke(arch), impl=ref_impl)
    got = tme.moe(tp, tx, cfg, impl="grouped")
    assert got.dtype == torch.float32 and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_grouped_matches_reference_bf16_where_routed_alike(arch):
    """In bf16 the grouped MoE rounds as the dense one does (g and u, the
    SiLU, the product and each expert's output to bf16, the combine in
    f32), so it is held to the reference's dense MoE."""
    cfg = get_smoke_config(arch)
    jp, tp = moe_params(arch, dtype=None)
    jx, tx = _x(cfg, (3, 16), None)
    _, wi = jme.router_probs(jp, jx, jget_smoke(arch))
    _, gi = tme.router_probs(tp, tx, cfg)
    same = (np.sort(gi.numpy(), -1) == np.sort(np.asarray(wi), -1)).all(-1)
    assert same.mean() > 0.9
    want = np.asarray(jme.moe(jp, jx, jget_smoke(arch), impl="dense"),
                      np.float32)
    got = tme.moe(tp, tx, cfg, impl="grouped")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got)[same], want[same], **BF16_TOL)
    torch.testing.assert_close(got, tme.moe_dense(tp, tx, cfg),
                               rtol=2e-2, atol=2e-2)


def _grouped_case(ids, E=4, d=16, f=8, seed=0):
    """Seeded f32 inputs of a grouped FFN with the given expert ids
    [T, k]: (x, gates, ids, w_gate, w_up, w_down)."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.as_tensor(ids, dtype=torch.int64)
    T, k = ids.shape
    gates = torch.rand(T, k, generator=g) + 0.1
    return (torch.randn(T, d, generator=g), gates / gates.sum(-1, True),
            ids, torch.randn(E, d, f, generator=g),
            torch.randn(E, d, f, generator=g),
            torch.randn(E, f, d, generator=g))


def _token_by_token(x, gates, ids, wg, wu, wd):
    """Each token through its experts one at a time, in slot order."""
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(ids.shape[1]):
            e = int(ids[t, j])
            h = torch.nn.functional.silu(x[t] @ wg[e]) * (x[t] @ wu[e])
            out[t] += gates[t, j] * (h @ wd[e])
    return out


DISPATCH_CASES = {
    # an expert (2) with no rows, groups of 3, 4 and 5 rows
    "empty_expert": [[0, 1], [3, 0], [1, 3], [0, 3], [1, 0], [3, 1]],
    # 13 rows of expert 1: more than a 4-row tile and not a multiple of it
    "ragged_group": [[1, 0]] * 13 + [[2, 1]] * 2,
    "one_token": [[2, 0]],
    "one_expert": [[3]] * 9,
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_grouped_dispatch_edge_cases(case):
    """The plain dispatch (which the dispatch kernel must equal) on an
    expert with no rows, a group that is not a multiple of the tile, one
    token, and every token on one expert: a stable expert-sorted order,
    each expert's first row and first row tile; the plain grouped FFN
    equals the token-by-token sum."""
    x, gates, ids, wg, wu, wd = _grouped_case(DISPATCH_CASES[case])
    E, bm = wg.shape[0], 4
    pos, meta = kmg.dispatch_plain(ids, E, bm)
    n = ids.numel()
    assert pos.dtype == meta.dtype == torch.int32
    assert sorted(pos.tolist()) == list(range(n))      # a permutation
    order = torch.empty(n, dtype=torch.int64)
    order[pos.long()] = torch.arange(n)
    flat = ids.reshape(-1)
    assert flat[order].tolist() == sorted(flat.tolist())
    counts = [int((flat == e).sum()) for e in range(E)]
    starts = np.concatenate([[0], np.cumsum(counts)]).tolist()
    tiles = np.concatenate([[0], np.cumsum([-(-c // bm) for c in counts])])
    assert meta.tolist() == starts + tiles.tolist()
    for e in range(E):                                  # stable
        mine = order[starts[e]:starts[e + 1]].tolist()
        assert mine == sorted(mine)
    got = kops.moe_grouped(x, gates, ids, wg, wu, wd)
    torch.testing.assert_close(got, _token_by_token(x, gates, ids, wg, wu,
                                                    wd), **F32_TOL)


def test_grouped_combine_sums_in_slot_order():
    """The combine adds each slot's gated row in f32 in slot order, then
    rounds once to the rows' type."""
    g = torch.Generator().manual_seed(4)
    T, k, d = 5, 3, 8
    y = torch.randn(T * k, d, generator=g).to(torch.bfloat16)
    pos = torch.randperm(T * k, generator=g).int()
    gates = torch.rand(T, k, generator=g)
    want = torch.zeros(T, d)
    for j in range(k):
        want = want + gates[:, j:j + 1] * y[pos.view(T, k)[:, j].long()] \
            .float()
    got = kmg.combine_plain(y, pos, gates)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_engine_prefill_is_grouped_and_decode_dense(monkeypatch):
    """``ServingEngine`` asks for the grouped MoE in prefill and leaves
    the decode step dense."""
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine
    cfg = get_smoke_config("olmoe_1b_7b")
    seen = []
    plain = tme.moe

    def spy(p, x, cfg, impl="dense"):
        seen.append((impl, x.shape[1]))
        return plain(p, x, cfg, impl=impl)
    monkeypatch.setattr(tf.me, "moe", spy)
    eng = ServingEngine(cfg, batch_size=2, max_seq=64, page_size=16,
                        device="cpu")
    for n in (5, 20):
        eng.submit(np.arange(1, n + 1) % cfg.vocab, max_new_tokens=3)
    eng.run_until_done()
    moe_layers = cfg.n_superblocks * sum(
        f == "moe" for _, f in tf.layer_kinds(cfg))
    prefill = [impl for impl, s in seen if s > 1]
    decode = [impl for impl, s in seen if s == 1]
    assert prefill == ["grouped"] * 2 * moe_layers
    assert decode and set(decode) == {"dense"}
    assert len(decode) == eng.stats["decode_steps"] * moe_layers
