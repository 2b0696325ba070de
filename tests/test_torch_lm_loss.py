"""The port's training loss held to the JAX reference: ``lm_loss`` and the
gradient of every parameter leaf against
``jax.value_and_grad(repro.models.transformer.lm_loss)``, on the
reference's own smoke-config parameters carried by
``schema.from_numpy``: qwen2.5-3b, gemma2-27b (local layers, soft-caps),
olmoe-1b-7b (the dense MoE, and the ragged one against the reference's
ragged), mamba2-1.3b, jamba-v0.1-52b (the hybrid), pixtral-12b (from
``embeds``) and seamless-m4t-medium (with ``enc_embeds``).  Labels hold
-1s (the reference's ``take_along_axis`` wraps them to the last entry,
the mask zeroes their term).  The port's ``remat=True`` and
``remat=False`` must agree bit for bit (the recompute runs the same
operations).

Tolerances: with the parameters cast to f32, the loss within 1e-5
relative and each gradient leaf within 1e-4 of that leaf's largest
magnitude (the frameworks sum in other orders; measured up to 4.1e-5, on
jamba's eight layers); with the bf16 parameters as drawn (the dense
models, whose routes cannot flip), the loss within 1e-3 relative and
each leaf within 0.05 of its largest magnitude (bf16 keeps 8 mantissa
bits and the frameworks round activations at other steps; measured up
to 0.034, on seamless).  The chaotic MoE and SSM models are held in f32
only.  Inputs are made from a seed with numpy."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: breaks an import cycle)
from repro.configs import get_smoke_config as jget_smoke
from repro.models import schema as jsc
from repro.models import transformer as jtf
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import schema as tsc
from repro_torch.models import transformer as ttf

F32_TOL = dict(loss=1e-5, grad=1e-4)
BF16_TOL = dict(loss=1e-3, grad=0.05)
CASES = [("qwen2p5_3b", "bf16"), ("qwen2p5_3b", "f32"),
         ("gemma2_27b", "bf16"), ("gemma2_27b", "f32"),
         ("olmoe_1b_7b", "f32"), ("mamba2_1p3b", "f32"),
         ("jamba_v0p1_52b", "f32"), ("pixtral_12b", "bf16"),
         ("pixtral_12b", "f32"), ("seamless_m4t_medium", "bf16"),
         ("seamless_m4t_medium", "f32")]


def make_batch(cfg, B=2, S=64, seed=0):
    """Seeded inputs of ``steps.train_inputs``' names: tokens (or
    embeds), labels with the first 5 positions -1 (and one -2),
    enc_embeds for an encoder-decoder config; numpy arrays."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[:, :5] = -1
    labels[0, 5] = -2
    batch = {"labels": labels}
    if cfg.embeds_in:
        batch["embeds"] = (rng.normal(size=(B, S, cfg.d_model))
                           * 0.1).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.n_enc_layers:
        batch["enc_embeds"] = (rng.normal(
            size=(B, S // cfg.enc_seq_divisor, cfg.d_model))
            * 0.1).astype(np.float32)
    return batch


def reference_loss_and_grads(arch, dtype, batch, moe_impl="dense"):
    """The reference's initial smoke parameters (numpy tree, f32-cast for
    "f32"), its loss and its gradient leaves in ``jax.tree.leaves``'
    order."""
    cfg = jget_smoke(arch)
    params = jax.tree.map(np.asarray,
                          jsc.init(jtf.schema(cfg), jax.random.key(0)))
    if dtype == "f32":
        params = jax.tree.map(lambda a: a.astype(np.float32), params)
    loss, grads = jax.value_and_grad(jtf.lm_loss)(
        jax.tree.map(jnp.asarray, params), cfg,
        {k: jnp.asarray(v) for k, v in batch.items()}, moe_impl=moe_impl)
    return params, float(loss), [np.asarray(g, np.float32)
                                 for g in jax.tree.leaves(grads)]


def assert_grads_close(want, got, tol):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        b = b.float().numpy()
        assert a.shape == b.shape, i
        scale = max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(a - b).max()) / scale
        assert err <= tol, f"leaf {i}: {err:.3e} of its max {scale:.3e}"


@pytest.mark.parametrize("arch,dtype", CASES)
def test_lm_loss_and_grads_match_reference(arch, dtype):
    cfg = get_smoke_config(arch)
    batch = make_batch(cfg)
    npt, jloss, jgrads = reference_loss_and_grads(arch, dtype, batch)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    params = tsc.from_numpy(npt)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = {}
    for remat in (True, False):
        loss, grads = steps.loss_and_grads(params, cfg, tb, remat=remat)
        assert loss.dtype == torch.float32
        assert abs(float(loss) - jloss) <= tol["loss"] * abs(jloss)
        assert_grads_close(jgrads, grads, tol["grad"])
        runs[remat] = (loss, grads)
    assert torch.equal(runs[True][0], runs[False][0])
    for a, b in zip(runs[True][1], runs[False][1]):
        assert torch.equal(a, b)


def test_ragged_moe_grads_match_reference_ragged():
    """``moe_ragged`` under training: the slices written into its
    ``empty_like`` buffer and its host read-back of group sizes, run
    again by the recompute, give the reference's ragged gradients."""
    arch = "olmoe_1b_7b"
    cfg = get_smoke_config(arch)
    batch = make_batch(cfg, seed=1)
    npt, jloss, jgrads = reference_loss_and_grads(arch, "f32", batch,
                                                  moe_impl="ragged")
    loss, grads = steps.loss_and_grads(
        tsc.from_numpy(npt), cfg,
        {k: torch.from_numpy(v) for k, v in batch.items()},
        moe_impl="ragged")
    assert abs(float(loss) - jloss) <= F32_TOL["loss"] * abs(jloss)
    assert_grads_close(jgrads, grads, F32_TOL["grad"])


def test_all_labels_masked_gives_zero_loss():
    """Every label negative: the mean's denominator is clamped to 1, so
    the loss (and every gradient) is 0, as in the reference."""
    arch = "qwen2p5_3b"
    cfg = get_smoke_config(arch)
    batch = make_batch(cfg, S=16)
    batch["labels"][:] = -1
    npt, jloss, _ = reference_loss_and_grads(arch, "f32", batch)
    loss, grads = steps.loss_and_grads(
        tsc.from_numpy(npt), cfg,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert jloss == 0.0 and float(loss) == 0.0
    assert all(not bool(g.any()) for g in grads)


def test_forward_with_remat_equals_forward():
    """``forward`` and ``encode`` with ``remat=True`` give the plain
    forward's logits and encoder output, and ``Transformer`` still serves
    under inference mode."""
    cfg = get_smoke_config("seamless_m4t_medium")
    params = tsc.init(ttf.schema(cfg), torch.Generator().manual_seed(0),
                      "cpu")
    b = make_batch(cfg)
    toks = torch.from_numpy(b["tokens"])
    frames = torch.from_numpy(b["enc_embeds"])
    enc = ttf.encode(params, cfg, frames)
    assert torch.equal(enc, ttf.encode(params, cfg, frames, remat=True))
    assert torch.equal(ttf.forward(params, cfg, toks, enc_out=enc),
                       ttf.forward(params, cfg, toks, enc_out=enc,
                                   remat=True))
    model = ttf.Transformer(cfg, params)
    assert torch.equal(model(toks, enc_out=model.encode(frames)),
                       ttf.forward(params, cfg, toks, enc_out=enc))
