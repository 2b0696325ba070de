"""The port's Mamba2 mixer (``repro_torch.models.mamba2``) held to the JAX
reference's: the causal conv, the chunked SSD scan, the whole block with
its state handoff, the one-token recurrence, and decode after prefill
against the block over the same tokens, at the mamba2 and jamba smoke
configs.

Parameters come from the reference's ``schema.init`` over its
``mamba_schema``, carried over by ``schema.from_numpy``.  Its f32 leaves
start at zeros and ones (``A_log``, ``D``, ``dt_bias``, ``conv_b``); a
seeded numpy offset is added to them so that the decay, the skip and the
biases take values of their own.

Tolerances: 1e-5 (rtol and atol) with f32 parameters and inputs, where
only the summation order differs (pairwise contractions in the port, a
chunk loop in place of ``lax.scan``); 2e-4 where a state is carried over
16 decode steps or compared across two algorithms (the chunked scan
against the recurrence); ``BF16_TOL`` with bf16 parameters as drawn.
Inputs are made from a seed with numpy."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: breaks an import cycle)
from repro.configs import get_smoke_config as jget_smoke
from repro.models import mamba2 as jmm
from repro.models import schema as jsc
from repro_torch.configs import get_smoke_config
from repro_torch.models import mamba2 as tmm
from repro_torch.models import schema as tsc

F32_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
ARCHS = ("mamba2_1p3b", "jamba_v0p1_52b")


def mamba_params(arch, dtype=np.float32, seed=0):
    """(jax tree, port tree) of one mamba layer, cast to ``dtype`` unless
    it is None (bf16 as drawn); the f32 leaves offset from their inits."""
    cfg = jget_smoke(arch)
    npt = jax.tree.map(np.asarray, jsc.init(jmm.mamba_schema(cfg),
                                            jax.random.key(seed)))
    rng = np.random.default_rng(seed + 100)
    for k in ("A_log", "D", "dt_bias", "conv_b"):
        npt[k] = (npt[k] + 0.5 * rng.normal(size=npt[k].shape)) \
            .astype(np.float32)
    if dtype is not None:
        npt = jax.tree.map(lambda a: a.astype(dtype), npt)
    return jax.tree.map(jnp.asarray, npt), tsc.from_numpy(npt)


def _both(a, bf16=False):
    """The same seeded array as a jax and a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16 if bf16 else torch.float32)


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol=F32_TOL, **kw):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **tol, **kw)


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_causal_conv_matches_reference(arch, tail):
    cfg = get_smoke_config(arch)
    jp, tp = mamba_params(arch)
    C = cfg.d_inner + 2 * cfg.ssm_state
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.normal(size=(2, 5, C)))
    jt, tt = _both(rng.normal(size=(2, cfg.conv_width - 1, C))) if tail \
        else (None, None)
    wy, wt = jmm._causal_conv(jp, jx, jt)
    gy, gt = tmm._causal_conv(tp, tx, tt)
    _close(gy, wy)
    _close(gt, wt)
    assert gt.shape == (2, cfg.conv_width - 1, C)


@pytest.mark.parametrize("nc", [1, 4])
def test_ssd_chunked_matches_reference(nc):
    """S = chunk (no carried state) and 4 chunks (the recurrence)."""
    rng = np.random.default_rng(nc)
    B, Q, H, P, N = 2, 8, 3, 4, 5
    S = Q * nc
    jx, tx = _both(rng.normal(size=(B, S, H, P)))
    jd, td = _both(np.log1p(np.exp(rng.normal(size=(B, S, H)))))
    ja, ta = _both(-np.exp(rng.normal(size=(H,)) * 0.5))
    jb, tb = _both(rng.normal(size=(B, S, N)))
    jc, tc = _both(rng.normal(size=(B, S, N)))
    wy, wh = jmm._ssd_chunked(jx, jd, ja, jb, jc, chunk=Q)
    gy, gh = tmm._ssd_chunked(tx, td, ta, tb, tc, chunk=Q)
    _close(gy, wy)
    _close(gh, wh)
    assert gy.dtype == gh.dtype == torch.float32


@pytest.mark.parametrize("dtype", [np.float32, None])
@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_block_with_state_matches_reference(arch, dtype):
    cfg = get_smoke_config(arch)
    jp, tp = mamba_params(arch, dtype)
    jx, tx = _both(np.random.default_rng(2).normal(size=(2, 32, cfg.d_model)),
                   bf16=dtype is None)
    wy, ws = jmm.mamba_block(jp, jx, jget_smoke(arch), chunk=8,
                             return_state=True)
    gy, gs = tmm.mamba_block(tp, tx, cfg, chunk=8, return_state=True)
    tol = F32_TOL if dtype is not None else BF16_TOL
    _close(gy, wy, tol)
    _close(gs.ssm, ws.ssm, tol)
    _close(gs.conv, ws.conv, tol)
    assert gy.dtype == tx.dtype and gs.ssm.dtype == torch.float32
    assert gs.conv.dtype == tx.dtype     # the tail keeps the input's type
    assert torch.equal(tmm.mamba_block(tp, tx, cfg, chunk=8), gy)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_decode_from_init_state_matches_reference(arch):
    cfg = get_smoke_config(arch)
    jp, tp = mamba_params(arch)
    jst, tst = jmm.init_state(jget_smoke(arch), 3), tmm.init_state(cfg, 3)
    for a, b in zip(jst, tst):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
        assert b.dtype == torch.float32
    rng = np.random.default_rng(3)
    for step in range(4):
        jx, tx = _both(rng.normal(size=(3, 1, cfg.d_model)))
        wy, jst = jmm.mamba_decode(jp, jx, jst, jget_smoke(arch))
        gy, tst = tmm.mamba_decode(tp, tx, tst, cfg)
        _close(gy, wy, err_msg=f"step {step}")
        _close(tst.ssm, jst.ssm, err_msg=f"step {step}")
        _close(tst.conv, jst.conv, err_msg=f"step {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_continue_the_block(arch):
    """Prefill of 16 tokens, then k = 16 decode steps, equal the block
    over all 32 tokens (the chunked scan against the recurrence), in the
    port and in the reference."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp, tp = mamba_params(arch)
    jx, tx = _both(np.random.default_rng(4).normal(size=(2, 32, cfg.d_model)))
    whole = tmm.mamba_block(tp, tx, cfg, chunk=8)
    _close(whole, jmm.mamba_block(jp, jx, jcfg, chunk=8))
    _, st = tmm.mamba_block(tp, tx[:, :16], cfg, chunk=8, return_state=True)
    _, jst = jmm.mamba_block(jp, jx[:, :16], jcfg, chunk=8,
                             return_state=True)
    for t in range(16, 32):
        y, st = tmm.mamba_decode(tp, tx[:, t:t + 1], st, cfg)
        wy, jst = jmm.mamba_decode(jp, jx[:, t:t + 1], jst, jcfg)
        torch.testing.assert_close(y, whole[:, t:t + 1], **STATE_TOL)
        _close(y, wy, STATE_TOL, err_msg=f"position {t}")
    _, end = tmm.mamba_block(tp, tx, cfg, chunk=8, return_state=True)
    torch.testing.assert_close(st.ssm, end.ssm, **STATE_TOL)
    torch.testing.assert_close(st.conv, end.conv, **STATE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_at_last_pos_equals_the_unpadded_prompt(arch):
    """A padded prompt's state taken at each row's last real token equals
    the reference's state over the prompt alone, and the outputs up to it
    are unchanged."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp, tp = mamba_params(arch)
    jx, tx = _both(np.random.default_rng(5).normal(size=(2, 32, cfg.d_model)))
    last = torch.tensor([20, 31])
    y, st = tmm.mamba_block(tp, tx, cfg, chunk=8, return_state=True,
                            last_pos=last)
    torch.testing.assert_close(y[:, :21], tmm.mamba_block(tp, tx, cfg,
                                                          chunk=8)[:, :21])
    for row, n in enumerate(last.tolist()):
        _, ws = jmm.mamba_block(jp, jx[row:row + 1, :n + 1], jcfg,
                                chunk=n + 1, return_state=True)
        _close(st.ssm[row:row + 1], ws.ssm, STATE_TOL, err_msg=f"row {row}")
        _close(st.conv[row:row + 1], ws.conv, err_msg=f"row {row}")


def test_chunk_must_divide_the_length():
    """The reference fails on a reshape at a padded length of 80 (chunk
    min(64, 80) = 64); the port raises ``ValueError`` with the lengths."""
    cfg = get_smoke_config("mamba2_1p3b")
    _, tp = mamba_params("mamba2_1p3b")
    x = torch.zeros(1, 80, cfg.d_model)
    with pytest.raises(ValueError, match="length 80 .* chunk 64"):
        tmm.mamba_block(tp, x, cfg)
    assert tmm.mamba_block(tp, x[:, :64], cfg).shape == (1, 64, cfg.d_model)
