"""The port's MoE FFN (``repro_torch.models.moe``) held to the JAX
reference's on the reference's own parameters, carried over by
``schema.from_numpy``, at the olmoe, mixtral and jamba smoke configs.

The dense and the ragged implementations round at other steps in bf16
and may route a near-tied token to another expert, so each is held to
the reference's same implementation; the port's two are held to each
other in f32 only.

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
