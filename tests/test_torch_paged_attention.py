"""The port's paged decode attention held to the JAX reference: the plain
version the port runs on the CPU against the reference's jnp oracle and
its Pallas kernel in interpret mode, on the reference's sweep plus G = 1
with D = 80 and G = 8 with D = 128, with and without soft-capping and a
``start_pos`` window.  f32 at the reference's own bound (3e-5: the three
sum in other orders), bf16 inputs at 3e-2 (the output rounds to bf16, 8
mantissa bits).  An empty window gives zeros, as the Pallas kernel does;
the reference's oracle gives the mean of V there instead (ROADMAP C), so
that row is held to the interpret-mode kernel only."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: breaks an import cycle)
import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from test_torch_cuda import PAGED_SWEEP, _paged_case


def _port(case, dtype, **kw):
    q, kp, vp, bt, sl, start = map(torch.from_numpy, case)
    return tops.paged_attention(q.to(dtype), kp.to(dtype), vp.to(dtype), bt,
                                sl, start, **kw).float().numpy()


def _reference(case, dtype, backend, **kw):
    q, kp, vp, bt, sl, start = case
    args = [jnp.asarray(a, dtype) for a in (q, kp, vp)] \
        + [jnp.asarray(a) for a in (bt, sl, start)]
    if backend == "oracle":
        out = jref.paged_attention_ref(*args, **kw)
    else:
        out = jops.paged_attention(*args, backend="interpret", **kw)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("B,H,KVH,D,P,PPS", PAGED_SWEEP)
def test_paged_attention_matches_reference_f32(B, H, KVH, D, P, PPS,
                                               softcap):
    case = _paged_case(B, H, KVH, D, P, PPS, seed=B * 1000 + H * 10 + D,
                       start_hi=P)
    got = _port(case, torch.float32, softcap=softcap)
    assert got.shape == (B, H, D)
    for backend in ("oracle", "interpret"):
        np.testing.assert_allclose(
            got, _reference(case, jnp.float32, backend, softcap=softcap),
            rtol=3e-5, atol=3e-5, err_msg=backend)
    assert (case[5] > 0).any()          # some windows start past 0


@pytest.mark.parametrize("B,H,KVH,D,P,PPS", [PAGED_SWEEP[0], PAGED_SWEEP[4]])
def test_paged_attention_matches_reference_bf16(B, H, KVH, D, P, PPS):
    case = _paged_case(B, H, KVH, D, P, PPS, seed=7 + D, start_hi=P)
    got = _port(case, torch.bfloat16, softcap=30.0)
    for backend in ("oracle", "interpret"):
        np.testing.assert_allclose(
            got, _reference(case, jnp.bfloat16, backend, softcap=30.0),
            rtol=3e-2, atol=3e-2, err_msg=backend)


def test_paged_attention_empty_window_gives_zeros():
    case = list(_paged_case(3, 8, 2, 16, 8, 3, seed=11))
    start = case[5].copy()
    start[1] = case[4][1]               # start_pos == seq_len: no position
    case[5] = start
    got = _port(case, torch.float32)
    interp = _reference(case, jnp.float32, "interpret")
    assert np.abs(got[1]).max() == 0.0 and np.abs(interp[1]).max() == 0.0
    np.testing.assert_allclose(got, interp, rtol=3e-5, atol=3e-5)
    oracle = _reference(case, jnp.float32, "oracle")
    np.testing.assert_allclose(got[[0, 2]], oracle[[0, 2]], rtol=3e-5,
                               atol=3e-5)
    assert np.abs(oracle[1]).max() > 0  # the oracle's uniform mean
