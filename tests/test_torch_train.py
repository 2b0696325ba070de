"""The port's training substrate held to the JAX reference: AdamW and its
schedule (with and without a ``GradCompressor`` hook), clipping, the
compression functions, the token pipeline, checkpoints written by one
package and restored by the other, the Honeycomb catalog's floor lookups
and retention, the train loop (restart, stragglers, a falling loss) and
``launch/steps.train_step`` against the reference's ``build_step`` train
branch on a one-device mesh.

Tolerances: the optimizer's f32 state and the compressor's outputs and
residuals within 1e-6 of each leaf's largest magnitude (the same ops in
f32; the frameworks' ``pow``/``cos`` and sum orders may differ in the
last bit); bf16 parameters also within one bf16 ulp (2^-8 relative) of
the reference's, since a last-bit f32 difference can round either way;
error-feedback residuals within 1e-4 of their largest magnitude (a
residual is the gradient less its int8 rounding, ~1/254 of the gradient's
scale, so a last-bit difference of the gradient is ~1.5e-5 of it); the
train step's f32 state within 1e-4 of each leaf's largest magnitude (the
gradients come through two frameworks' backward passes, as in
tests/test_torch_lm_loss.py).  Data, checkpoints and restarts are held
bit for bit.  Inputs are made from a seed with numpy."""
from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: breaks an import cycle)
from repro.configs import get_smoke_config as jget_smoke
from repro.data import pipeline as jdata
from repro.distributed import compression as jcomp
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh
from repro.models import schema as jsc
from repro.models import transformer as jtf
from repro.models.config import ShapeConfig as JShapeConfig
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline as tdata
from repro_torch.distributed import compression as tcomp
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import schema as tsc
from repro_torch.models import transformer as ttf
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_loop import (LoopConfig, TrainLoop,
                                          build_smoke_loop)

OPT_TOL = dict(rtol=1e-6)
RES_REL = 1e-4
STEP_TOL = 1e-4


def tiny_cfg():
    return dataclasses.replace(get_smoke_config("qwen2p5_3b"),
                               n_layers=2, d_model=64, d_ff=128, vocab=128)


def _np(x):
    """A tensor or jax array as numpy, bf16 widened to f32."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes (bf16 as its 16-bit patterns)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.reshape(-1).numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def opt_tree(seed=0):
    """A parameter tree of mixed dtypes and its gradients (numpy):
    insertion order unlike sorted order, as the model's is."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)
    params = {"w": arr(4, 6), "b": {"z": arr(6), "a": arr(3, 2)},
              "e": arr(8, 4)}
    return params, ("e", "w")           # leaves kept in bf16


def _trees(params, bf16, dev="cpu"):
    """(jax tree, torch tree) of ``params`` with ``bf16``'s leaves in
    bf16, the torch leaves fresh tensors."""
    import ml_dtypes
    npt = {k: (v.astype(ml_dtypes.bfloat16) if k in bf16 else v)
           if not isinstance(v, dict) else v for k, v in params.items()}
    return (jax.tree.map(jnp.asarray, npt),
            tsc.from_numpy(npt, dev))


def assert_close_leaves(jtree, ttree, rel=1e-6):
    """Every leaf within ``rel`` of that leaf's largest magnitude (a
    moment summed from terms of both signs can land near 0, where a
    last-bit difference is large beside it); bf16 leaves also within one
    bf16 ulp (2^-8 relative) of each entry."""
    jl, tl = jax.tree.leaves(jtree), tsc.flatten(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a, b16 = _np(a), b.dtype == torch.bfloat16
        atol = rel * max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(_np(b), a, rtol=2 ** -8 if b16 else 0,
                                   atol=atol)


# ----------------------------------------------------------------- optimizer
@pytest.mark.parametrize("hook", [None, "int8", "topk"])
def test_adamw_steps_match_reference(hook):
    """Five AdamW steps (warmup, clipping, weight decay, the schedule)
    on a mixed bf16/f32 tree, through an error-feedback compressor hook
    or none: parameters, moments, step and gnorm against the
    reference's ``opt.update``."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=8, clip_norm=0.5)
    params, bf16 = opt_tree()
    jp, tp = _trees(params, bf16)
    js, ts = jopt.init(jp), topt.init(tp)
    jhook = thook = None
    if hook:
        jc, tc = jcomp.GradCompressor(hook, 0.25), \
            tcomp.GradCompressor(hook, 0.25)
        jst, tst = [jc.init(jp)], [tc.init(tp)]

        def jhook(g):
            out, jst[0] = jc(g, jst[0])
            return out

        def thook(g):
            out, tst[0] = tc(g, tst[0])
            return out
    rng = np.random.default_rng(1)
    for _ in range(5):
        g = {k: rng.normal(size=np.shape(v)).astype(np.float32)
             if not isinstance(v, dict) else
             {kk: rng.normal(size=vv.shape).astype(np.float32)
              for kk, vv in v.items()} for k, v in params.items()}
        jg, tg = _trees(g, bf16)
        jp, js, jn = jopt.update(jopt.AdamWConfig(**cfg), jg, js, jp,
                                 grad_transform=jhook)
        tp, ts, tn = topt.update(topt.AdamWConfig(**cfg), tg, ts, tp,
                                 grad_transform=thook)
        np.testing.assert_allclose(float(tn), float(jn), **OPT_TOL)
        assert int(ts.step) == int(js.step)
        assert_close_leaves(js.mu, ts.mu)
        assert_close_leaves(js.nu, ts.nu)
        assert_close_leaves(jp, tp)
        if hook:
            assert_close_leaves(jst[0].residual, tst[0].residual, RES_REL)
    assert ts.step.dtype == torch.int32 and all(
        m.dtype == torch.float32 for m in tsc.flatten(ts.mu))


def test_adamw_updates_in_place():
    """``update`` writes the parameters and moments where they lie and
    scales f32 gradients where they lie."""
    params, _ = opt_tree()
    _, tp = _trees(params, ())
    ts = topt.init(tp)
    grads = tsc.map_tree(lambda t: torch.ones_like(t), tp)
    ptrs = [t.data_ptr() for t in tsc.flatten((tp, ts.mu, ts.nu, grads))]
    new, ns, _ = topt.update(topt.AdamWConfig(clip_norm=0.5), grads, ts, tp)
    assert [t.data_ptr() for t in tsc.flatten((new, ns.mu, ns.nu, grads))] \
        == ptrs
    assert float(topt.global_norm(grads)) == pytest.approx(0.5, rel=1e-6)


def test_adamw_first_step_and_clipping_as_reference_tests():
    """The reference tests' own expectations, on the port."""
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1, weight_decay=0.0,
                           clip_norm=1e9)
    params = {"w": torch.tensor([1.0, -2.0, 3.0])}
    new, _, gnorm = topt.update(cfg, {"w": torch.tensor([0.1, -0.2, 0.3])},
                                topt.init(params), params)
    m = 0.1 * np.array([0.1, -0.2, 0.3])
    v = 0.05 * np.array([0.1, -0.2, 0.3]) ** 2
    want = np.array([1.0, -2.0, 3.0]) - 1e-2 * (m / 0.1) / (
        np.sqrt(v / 0.05) + 1e-8)
    np.testing.assert_allclose(new["w"].numpy(), want, rtol=1e-5)
    assert float(gnorm) == pytest.approx(np.sqrt(0.14), rel=1e-5)

    params = {"w": torch.ones(4)}
    _, st, gnorm = topt.update(topt.AdamWConfig(clip_norm=0.1),
                               {"w": torch.full((4,), 100.0)},
                               topt.init(params), params)
    assert float(gnorm) > 100
    assert float(st.mu["w"].abs().max()) < 1.0      # clipped before mu


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (0, 1), (5, 3)])
def test_schedule_and_abstract_state_match_reference(warmup, total):
    jc = jopt.AdamWConfig(warmup_steps=warmup, total_steps=total)
    tc = topt.AdamWConfig(warmup_steps=warmup, total_steps=total)
    for s in (0, 1, 2, 5, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000):
        np.testing.assert_allclose(
            float(topt._schedule(tc, torch.tensor(float(s)))),
            float(jopt._schedule(jc, jnp.float32(s))), rtol=1e-6,
            atol=1e-12)
    js = jopt.abstract_state(jsc.abstract(jtf.schema(jget_smoke(
        "qwen2p5_3b"))))
    ts = topt.abstract_state(tsc.map_tree(
        lambda d: tsc.Spec(d.shape, d.dtype),
        ttf.schema(get_smoke_config("qwen2p5_3b"))))
    jl, tl = jax.tree.leaves(js), tsc.flatten(ts)
    assert [(tuple(a.shape), np.dtype(a.dtype).name) for a in jl] \
        == [(b.shape, str(b.dtype).removeprefix("torch.")) for b in tl]


# --------------------------------------------------------------- compression
def test_compression_functions_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(257,)).astype(np.float32)
    x[:4] = [0.5, -0.5, 1.5, 2.5]       # ties for the rounding
    jq, js = jcomp.int8_quantize(jnp.asarray(x))
    tq, ts = tcomp.int8_quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(
        tcomp.int8_dequantize(tq, ts).numpy(),
        np.asarray(jcomp.int8_dequantize(jq, js)))
    half = np.array([0.5, 1.5, 2.5, -0.5, -2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(half)),
                                  np.asarray(jnp.round(half)))
    for frac in (0.01, 0.1, 0.5, 1.0):
        jy, jm = jcomp.topk_sparsify(jnp.asarray(x.reshape(1, 257)), frac)
        ty, tm = tcomp.topk_sparsify(torch.from_numpy(x.reshape(1, 257)),
                                     frac)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    for mode in ("int8", "topk", "none"):
        assert tcomp.GradCompressor(mode).wire_bytes_per_value() \
            == jcomp.GradCompressor(mode).wire_bytes_per_value()
    with pytest.raises(ValueError):
        tcomp.GradCompressor("fp4")


@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_error_feedback_matches_reference(mode):
    """Twenty compressed steps: every output and the residual against the
    reference's; the sum sent plus the residual is the sum of the true
    gradients."""
    jc, tc = jcomp.GradCompressor(mode, 0.1), tcomp.GradCompressor(mode, 0.1)
    shapes = {"w": (64,), "m": {"k": (8, 4)}}
    zeros = tsc.map_tree(lambda s: np.zeros(s, np.float32), shapes)
    jst, tst = jc.init(jax.tree.map(jnp.asarray, zeros)), \
        tc.init(tsc.from_numpy(zeros))
    rng = np.random.default_rng(1)
    true = sent = 0.0
    for _ in range(20):
        g = tsc.map_tree(lambda s: rng.normal(size=s).astype(np.float32),
                         shapes)
        jo, jst = jc(jax.tree.map(jnp.asarray, g), jst)
        to, tst = tc(tsc.from_numpy(g), tst)
        assert_close_leaves(jo, to)
        true = true + g["w"]
        sent = sent + to["w"].numpy()
    assert_close_leaves(jst.residual, tst.residual, RES_REL)
    np.testing.assert_allclose(sent + tst.residual["w"].numpy(), true,
                               atol=1e-3)


# ---------------------------------------------------------------- pipeline
@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (5, 0, 4),
                                                  (5, 1, 4), (5, 3, 4),
                                                  (1234, 1, 2)])
def test_sources_bit_equal_to_reference(tmp_path, step, shard, n_shards):
    for args in ((100, 1), (151936, 0, 0.3)):
        want = jdata.SyntheticSource(*args).batch(step, shard, n_shards, 8,
                                                  16)
        got = tdata.SyntheticSource(*args).batch(step, shard, n_shards, 8,
                                                 16)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    path = tmp_path / "toks.bin"
    np.random.default_rng(2).integers(0, 1 << 20, 10_007).astype(
        np.int32).tofile(path)
    want = jdata.FileSource(str(path)).batch(step, shard, n_shards, 3, 17)
    got = tdata.FileSource(str(path)).batch(step, shard, n_shards, 3, 17)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


def test_file_source_roundtrip_as_reference_test(tmp_path):
    path = tmp_path / "toks.bin"
    np.arange(10000, dtype=np.int32).tofile(path)
    b = tdata.FileSource(str(path)).batch(0, 0, 2, 2, 8)
    np.testing.assert_array_equal(b["tokens"][0], np.arange(8))
    np.testing.assert_array_equal(b["labels"][0], np.arange(1, 9))


def test_pipeline_prefetch_seek_state_match_reference():
    kw = dict(global_batch=4, seq_len=8, shard=1, n_shards=2, start_step=7)
    jp = jdata.DataPipeline(jdata.SyntheticSource(50, seed=2), **kw)
    tp = tdata.DataPipeline(tdata.SyntheticSource(50, seed=2), **kw)
    try:
        for _ in range(3):
            a, b = next(jp), next(tp)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert tp.state() == jp.state() == {"step": 10, "shard": 1,
                                            "n_shards": 2}
        jp.seek(3)
        tp.seek(3)
        np.testing.assert_array_equal(next(jp)["labels"],
                                      next(tp)["labels"])
        assert tp.state()["step"] == 4
    finally:
        jp.close()
        tp.close()
    assert not tp._thread.is_alive()
    with pytest.raises(ValueError):
        tdata.DataPipeline(tdata.SyntheticSource(50), global_batch=5,
                           seq_len=8, n_shards=2)


def test_pipeline_counts_starvations():
    """A source slower than the consumer leaves the queue empty: counted
    per ``next`` that finds it so, and the batches stay in step order."""
    class Slow(tdata.SyntheticSource):
        def batch(self, step, *a):
            time.sleep(0.05)
            return super().batch(step, *a)
    p = tdata.DataPipeline(Slow(50), global_batch=2, seq_len=4)
    try:
        got = [next(p)["tokens"] for _ in range(4)]
    finally:
        p.close()
    assert p.starvations >= 3
    src = tdata.SyntheticSource(50)
    for i, t in enumerate(got):
        np.testing.assert_array_equal(t, src.batch(i, 0, 1, 2, 4)["tokens"])


# ------------------------------------------------------------- checkpoints
def _state_trees(seed=0):
    """A bf16/f32 parameter tree with an ``OptState`` at step 7, as
    (jax tree, torch tree)."""
    params, bf16 = opt_tree(seed)
    jp, tp = _trees(params, bf16)
    rng = np.random.default_rng(seed + 1)
    mom = tsc.map_tree(lambda a: rng.normal(size=a.shape).astype(np.float32),
                       params)
    js = jopt.OptState(jnp.int32(7), jax.tree.map(jnp.asarray, mom),
                       jax.tree.map(lambda a: jnp.asarray(a * a), mom))
    ts = topt.OptState(torch.tensor(7, dtype=torch.int32),
                       tsc.from_numpy(mom),
                       tsc.from_numpy(tsc.map_tree(lambda a: a * a, mom)))
    return (jp, js), (tp, ts)


def test_reference_checkpoint_restores_in_port_bit_for_bit(tmp_path):
    jtree, ttree = _state_trees()
    JCheckpointManager(tmp_path, keep=5).save(7, jtree, extra={"a": 1})
    ck = CheckpointManager(tmp_path, keep=5, device="cpu")
    assert ck.all_steps() == [7] and ck.latest_step(100) == 7
    like = (tsc.map_tree(torch.zeros_like, ttree[0]), ttree[1])
    (params, st), manifest = ck.restore(7, like)
    assert manifest["extra"] == {"a": 1}
    assert isinstance(st, topt.OptState) and list(params) == ["w", "b", "e"]
    jl, tl = jax.tree.leaves(jtree), tsc.flatten((params, st))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert str(b.dtype).removeprefix("torch.") == np.asarray(a).dtype.name
        np.testing.assert_array_equal(_bits(b), _bits(a))


def test_port_checkpoint_restores_in_reference_bit_for_bit(tmp_path):
    jtree, ttree = _state_trees(3)
    ck = CheckpointManager(tmp_path, keep=5, device="cpu")
    ck.save(11, ttree, blocking=False)
    ck.wait()
    jck = JCheckpointManager(tmp_path, keep=5)
    assert jck.all_steps() == [11]
    back, manifest = jck.restore(11, jtree)
    saved = jax.tree.leaves(jtree)
    for a, b in zip(jax.tree.leaves(back), tsc.flatten(ttree)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
        assert np.asarray(a).dtype.name == \
            str(b.dtype).removeprefix("torch.")
    assert len(jax.tree.leaves(back)) == len(saved) == manifest["n_leaves"]
    files = sorted(p.name for p in (tmp_path / "step_0000000011").iterdir())
    assert files == ["leaf_%05d.npy" % i for i in range(len(saved))] \
        + ["manifest.json"]


def test_checkpoint_catalog_floor_lookup_and_retention(tmp_path):
    """The reference tests' expectations, and the port's catalog against
    the reference's on the same saves."""
    ck = CheckpointManager(tmp_path / "a", keep=10, device="cpu")
    jck = JCheckpointManager(tmp_path / "b", keep=10)
    for s in (10, 20, 40):
        ck.save(s, {"x": torch.ones(3) * s})
        jck.save(s, {"x": jnp.ones(3) * s})
    assert ck.latest_step() == 40
    assert ck.latest_step(at_or_before=35) == 20
    assert ck.latest_step(at_or_before=10) == 10
    for q in (None, 0, 5, 9, 10, 11, 39, 40, 41, 10 ** 9):
        assert ck.latest_step(q) == jck.latest_step(q), q
    tree, _ = ck.restore(20, {"x": torch.zeros(3)})
    assert float(tree["x"][0]) == 20.0

    ck = CheckpointManager(tmp_path / "c", keep=2, device="cpu")
    jck = JCheckpointManager(tmp_path / "d", keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.zeros(2)})
        jck.save(s, {"x": jnp.zeros(2)})
        assert ck.all_steps() == jck.all_steps()
    assert ck.all_steps() == [3, 4]
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) \
        == ["step_0000000003", "step_0000000004"]
    # a fresh manager finds the published checkpoints (not a .tmp)
    (tmp_path / "c" / "step_0000000009.tmp").mkdir()
    assert CheckpointManager(tmp_path / "c", device="cpu").all_steps() \
        == [3, 4]


def test_cuda_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckpointManager(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_smoke_loop(tiny_cfg(), ckpt_dir=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--steps", "2", "--ckpt-dir",
                     str(tmp_path)])


# ------------------------------------------------------------------ the loop
def _loop(tmp_path, name, lc, **kw):
    return build_smoke_loop(tiny_cfg(), batch=8, seq=32,
                            ckpt_dir=tmp_path / name, loop_cfg=lc,
                            device="cpu", **kw)


def test_loss_decreases_and_checkpoints(tmp_path):
    loop = _loop(tmp_path, "a", LoopConfig(total_steps=60, ckpt_every=30,
                                           log_every=10))
    try:
        summary = loop.run()
    finally:
        loop.pipeline.close()
    losses = [m["loss"] for m in loop.metrics_log]
    assert losses[-1] < losses[0] - 0.3, losses
    assert loop.ckpt.all_steps() == [30, 60]
    assert summary["final_step"] == 60 and len(losses) == 6
    assert all(np.isfinite(m["gnorm"]) for m in loop.metrics_log)


def test_restart_resumes_bit_for_bit(tmp_path):
    """20 steps straight against 10, a crash, a fresh loop that restores
    the newest checkpoint and runs 10 more: every leaf of the parameters
    and the optimizer state equal bit for bit."""
    lc = LoopConfig(total_steps=20, ckpt_every=10, log_every=5)
    a = _loop(tmp_path, "a", lc)
    try:
        a.run()
    finally:
        a.pipeline.close()
    b = _loop(tmp_path, "b", lc)
    try:
        b.run(steps=10)
    finally:
        b.pipeline.close()
    c = _loop(tmp_path, "b", lc, seed=5)     # other initial parameters
    try:
        assert c.restore_latest()
        assert c.step == 10 and c.pipeline.state()["step"] == 10
        c.run(steps=10)
    finally:
        c.pipeline.close()
    la, lc_ = tsc.flatten((a.params, a.opt_state)), \
        tsc.flatten((c.params, c.opt_state))
    assert len(la) == len(lc_)
    for x, y in zip(la, lc_):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert [m["loss"] for m in a.metrics_log][2:] \
        == [m["loss"] for m in c.metrics_log]


def test_straggler_detection(tmp_path):
    """A delay injected into step 8, ten times the slowest step before it
    but the first (at least 1 s, so that a loaded machine cannot hide
    it), is reported
    at step 8 through the callback and leaves the watermark alone."""
    loop = _loop(tmp_path, "a", LoopConfig(total_steps=10, ckpt_every=100,
                                           log_every=100,
                                           straggler_factor=5.0))
    orig = loop.step_fn
    took = []
    seen = []

    def slow_step(p, o, b):
        if len(took) == 7:
            time.sleep(max(1.0, 10 * max(took[1:])))   # injected straggler
        t0 = time.perf_counter()
        out = orig(p, o, b)
        took.append(time.perf_counter() - t0)
        return out

    loop.step_fn = slow_step
    loop.on_straggler = lambda step, dt: seen.append(step)
    try:
        summary = loop.run()
    finally:
        loop.pipeline.close()
    events = [s for s, _ in loop.straggler_events]
    assert 8 in events and 8 in seen and seen == events
    assert summary["stragglers"] == len(events)
    assert loop._ema < 5 * max(took[1:])  # the slow step left the watermark


def test_loop_matches_reference_loop(tmp_path):
    """The port's loop from the reference's own initial parameters (f32)
    against the reference's ``build_smoke_loop`` for 6 steps: every
    logged loss and gnorm, and the final parameters."""
    from repro.train import train_loop as jloop
    cfg = tiny_cfg()
    lc = LoopConfig(total_steps=6, ckpt_every=100, log_every=1)
    ja = jloop.build_smoke_loop(cfg, batch=4, seq=16,
                                ckpt_dir=str(tmp_path / "j"), loop_cfg=lc)
    ja.params = jax.tree.map(lambda a: a.astype(jnp.float32), ja.params)
    ja.opt_state = jopt.init(ja.params)
    t = build_smoke_loop(cfg, batch=4, seq=16, ckpt_dir=tmp_path / "t",
                         loop_cfg=lc, device="cpu")
    t.params = tsc.from_numpy(jax.tree.map(np.asarray, ja.params))
    t.opt_state = topt.init(t.params)
    try:
        ja.run()
        t.run()
    finally:
        ja.pipeline.close()
        t.pipeline.close()
    for a, b in zip(ja.metrics_log, t.metrics_log):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        np.testing.assert_allclose(b["gnorm"], a["gnorm"], rtol=1e-4)
    for a, b in zip(jax.tree.leaves(ja.params), tsc.flatten(t.params)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-4, atol=1e-5)


def test_train_cli_on_the_cpu(tmp_path, capsys):
    summary = ttrain.main(["--smoke", "--steps", "4", "--batch", "4",
                           "--seq", "16", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert summary["final_step"] == 4 and '"step": 4' in out
    summary = ttrain.main(["--smoke", "--steps", "2", "--batch", "4",
                           "--seq", "16", "--device", "cpu", "--resume",
                           "--ckpt-dir", str(tmp_path)])
    assert "resumed from step 4" in capsys.readouterr().out
    assert summary["final_step"] == 6


# ---------------------------------------------------------------- the step
def test_train_step_matches_reference_build_step():
    """``train_step(accum=2)`` against the reference's ``build_step``
    train branch, jitted on a one-device mesh, from the same f32
    parameters and batch (4 x 32 tokens, labels with -1s): loss, gnorm,
    the new parameters, mu, nu and step."""
    jcfg, tcfg = jget_smoke("qwen2p5_3b"), get_smoke_config("qwen2p5_3b")
    built = jsteps.build_step(jcfg, JShapeConfig("t", "train", 32, 4),
                              make_mesh((1, 1), ("data", "model")),
                              grad_accum=2)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jsc.init(jtf.schema(jcfg), jax.random.key(0)))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (4, 32)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (4, 32)).astype(np.int32)}
    batch["labels"][:, :3] = -1
    jp = jax.tree.map(jnp.asarray, params)
    jnew, jst, jm = jax.jit(built.fn)(jp, jopt.init(jp), batch)
    tp = tsc.from_numpy(params)
    tnew, tst, tm = tsteps.train_step(tp, topt.init(tp), batch, tcfg,
                                      topt.AdamWConfig(), accum=2)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]),
                               rtol=1e-5)
    assert int(tst.step) == int(jst.step) == 1
    for jt, tt in ((jnew, tnew), (jst.mu, tst.mu), (jst.nu, tst.nu)):
        jl, tl = jax.tree.leaves(jt), tsc.flatten(tt)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            a = np.asarray(a)
            scale = max(float(np.abs(a).max()), 1e-30)
            assert float(np.abs(a - _np(b)).max()) <= STEP_TOL * scale


def test_train_step_accum_falls_back_and_sums_in_f32():
    """An ``accum`` that does not divide the batch runs one microbatch;
    two microbatches sum their bf16 gradients in f32, so the step equals
    one made from the f32 sum of the two microbatches' gradients."""
    cfg = tiny_cfg()
    params = tsc.init(ttf.schema(cfg), torch.Generator().manual_seed(0),
                      "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 16)),
             "labels": rng.integers(0, cfg.vocab, (4, 16))}
    ocfg = topt.AdamWConfig()
    p1 = tsc.map_tree(torch.clone, params)
    p1, s1, m1 = tsteps.train_step(p1, topt.init(p1), batch, cfg, ocfg,
                                   accum=3)
    p0 = tsc.map_tree(torch.clone, params)
    p0, s0, m0 = tsteps.train_step(p0, topt.init(p0), batch, cfg, ocfg,
                                   accum=1)
    assert float(m1["loss"]) == float(m0["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tsc.flatten(p1),
                                                  tsc.flatten(p0)))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    halves = [tsteps.loss_and_grads(params, cfg, {k: v[i:i + 2]
                                                  for k, v in tb.items()})
              for i in (0, 2)]
    gsum = [a.float() + b.float()
            for a, b in zip(halves[0][1], halves[1][1])]
    want = tsc.map_tree(torch.clone, params)
    want, _, gnorm = topt.update(ocfg, tsc.unflatten(
        params, [g / 2 for g in gsum]), topt.init(want), want)
    p2 = tsc.map_tree(torch.clone, params)
    p2, s2, m2 = tsteps.train_step(p2, topt.init(p2), batch, cfg, ocfg,
                                   accum=2)
    assert float(m2["loss"]) == pytest.approx(
        float((halves[0][0] + halves[1][0]) / 2), rel=1e-6)
    assert float(m2["gnorm"]) == float(gnorm)
    assert all(torch.equal(a, b) for a, b in zip(tsc.flatten(p2),
                                                  tsc.flatten(want)))


def test_train_loop_accepts_a_step_of_its_own(tmp_path):
    """``TrainLoop`` over a step a caller assembles: ``loss_and_grads``
    and AdamW through a ``GradCompressor`` hook, checkpointed every 2
    steps with one kept."""
    cfg = tiny_cfg()
    params = tsc.init(ttf.schema(cfg), torch.Generator().manual_seed(1),
                      "cpu")
    comp = tcomp.GradCompressor("int8")
    cst = [comp.init(params)]

    def hook(g):
        out, cst[0] = comp(g, cst[0])
        return out
    ocfg = topt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)

    def step_fn(p, o, b):
        loss, grads = tsteps.loss_and_grads(
            p, cfg, {k: torch.as_tensor(v) for k, v in b.items()})
        p, o, gnorm = topt.update(ocfg, tsc.unflatten(p, grads), o, p,
                                  grad_transform=hook)
        return p, o, {"loss": loss, "gnorm": gnorm}
    loop = TrainLoop(step_fn, params, topt.init(params),
                     tdata.DataPipeline(tdata.SyntheticSource(cfg.vocab),
                                        global_batch=4, seq_len=16),
                     CheckpointManager(tmp_path, keep=1, device="cpu"),
                     LoopConfig(total_steps=4, ckpt_every=2, log_every=1))
    try:
        loop.run()
    finally:
        loop.pipeline.close()
    assert loop.ckpt.all_steps() == [4]
    assert [m["step"] for m in loop.metrics_log] == [1, 2, 3, 4]
    assert any(bool(r.any()) for r in tsc.flatten(cst[0].residual))
