"""The port's paged decode attention held to the JAX reference: the plain
version the port runs on the CPU against the reference's jnp oracle and
its Pallas kernel in interpret mode, on the reference's sweep plus G = 1
with D = 80 and G = 8 with D = 128, with and without soft-capping and a
``start_pos`` window.  f32 at the reference's own bound (3e-5: the three
sum in other orders), bf16 inputs at 3e-2 (the output rounds to bf16, 8
mantissa bits).  An empty window gives zeros, as the Pallas kernel does;
the reference's oracle gives the mean of V there instead (ROADMAP C), so
that row is held to the interpret-mode kernel only.

The CUDA kernel splits each sequence's positions into spans and combines
the spans' partial softmax states in a second pass; its plain mirror
(``ref.paged_attention_split_ref``) is held to the same references at
spans of 8 and 16 positions, with windows that start inside a span, spans
wholly outside the window and an empty window, and ``span_plan``, which
sizes the split, is checked for coverage, tiles and shared memory."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: breaks an import cycle)
import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
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


def _split(case, dtype, span, **kw):
    q, kp, vp, bt, sl, start = map(torch.from_numpy, case)
    return tref.paged_attention_split_ref(
        q.to(dtype), kp.to(dtype), vp.to(dtype), bt, sl, start, span=span,
        **kw).float().numpy()


@functools.lru_cache(maxsize=None)
def _split_case(shape, dtype_name, softcap):
    """A sweep case with windows starting anywhere in the first page (so
    inside a span) and its two references, computed once for both
    spans."""
    B, H, KVH, D, P, PPS = shape
    case = _paged_case(B, H, KVH, D, P, PPS, seed=B * 100 + H + D + 3,
                       start_hi=P)
    dt = getattr(jnp, dtype_name)
    return case, {b: _reference(case, dt, b, softcap=softcap)
                  for b in ("oracle", "interpret")}


@pytest.mark.parametrize("span", [8, 16])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("shape", PAGED_SWEEP)
def test_split_combine_matches_reference_f32(shape, softcap, span):
    case, refs = _split_case(shape, "float32", softcap)
    got = _split(case, torch.float32, span, softcap=softcap)
    for backend, want in refs.items():
        np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5,
                                   err_msg=backend)
    assert ((case[5] % span) != 0).any()        # a window starts mid-span


@pytest.mark.parametrize("span", [8, 16])
@pytest.mark.parametrize("shape", PAGED_SWEEP)
def test_split_combine_matches_reference_bf16(shape, span):
    case, refs = _split_case(shape, "bfloat16", 30.0)
    got = _split(case, torch.bfloat16, span, softcap=30.0)
    for backend, want in refs.items():
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2,
                                   err_msg=backend)


@pytest.mark.parametrize("span", [8, 16])
def test_split_combine_empty_window_and_whole_spans_outside(span):
    """Sequence 1 sees nothing (zeros); sequence 0's window starts deep
    inside its positions, so whole spans lie below it and above it."""
    case = list(_paged_case(3, 8, 2, 16, 8, 6, seed=12))
    sl, start = case[4].copy(), case[5].copy()
    sl[:] = [40, 17, 48]
    start[:] = [19, 17, 0]
    case[4], case[5] = sl, start
    got = _split(case, torch.float32, span)
    interp = _reference(case, jnp.float32, "interpret")
    assert np.abs(got[1]).max() == 0.0
    np.testing.assert_allclose(got, interp, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(got, _port(case, torch.float32), rtol=3e-5,
                               atol=3e-5)


#: (B, H, KVH, PPS, P, D): the serving path's qwen2.5-3b, gemma2-27b,
#: gemma3-12b, stablelm-3b, a long context at a large batch, and tiny ones
PLAN_SHAPES = [(8, 16, 2, 32, 256, 128), (8, 32, 16, 32, 256, 128),
               (8, 16, 8, 32, 256, 256), (8, 32, 32, 32, 256, 80),
               (128, 16, 2, 128, 256, 128), (2, 4, 2, 3, 8, 16),
               (1, 16, 1, 1, 8, 256), (4, 48, 3, 7, 16, 8)]


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,PPS,P,D", PLAN_SHAPES)
def test_span_plan_covers_positions_in_whole_tiles(B, H, KVH, PPS, P, D,
                                                   kv_dtype):
    plan = tpa.span_plan(B, H, KVH, PPS, P, D, kv_dtype)
    total = PPS * P
    assert plan.span * plan.n_spans >= total
    assert plan.span * (plan.n_spans - 1) < total      # no span past them
    assert plan.tile in tpa.TILES and plan.span % plan.tile == 0
    assert plan.stages in (2, 3)
    assert plan.stages == 2 or plan.span // plan.tile >= 3
    assert plan.n_spans <= 65535
    elem = 2 if kv_dtype == torch.bfloat16 else 4
    assert plan.smem == tpa.smem_bytes(H // KVH, D, plan.tile, plan.stages,
                                       elem) <= tpa.MAX_SMEM
    ws = B * KVH * plan.n_spans * (H // KVH) * (D + 2) * 4
    assert ws <= tpa.MAX_WORKSPACE or plan.span >= total


def test_span_plan_at_the_serving_shapes():
    """qwen2.5-3b's decode step (8 slots, 32 pages of 256, D = 128, bf16):
    spans of 256 positions in tiles of 64, about 2 MB of workspace, and
    at least two blocks an SM; D = 256 stays under 227 KB at every G."""
    plan = tpa.span_plan(8, 16, 2, 32, 256, 128, torch.bfloat16)
    assert (plan.span, plan.n_spans, plan.tile) == (256, 32, 64)
    assert 2 * (plan.smem + 1024) <= 228 * 1024
    assert 8 * 2 * plan.n_spans * 8 * 130 * 4 == 2_129_920
    for G in (1, 2, 3, 8, 16):
        for dt in (torch.float32, torch.bfloat16):
            p = tpa.span_plan(8, 2 * G, 2, 32, 256, 256, dt)
            assert p.smem <= tpa.MAX_SMEM
