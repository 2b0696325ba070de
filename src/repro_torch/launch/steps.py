"""Input specs and the serving steps for every (arch x shape) cell: the
one-device serving half of ``repro.launch.steps``.

``train_inputs``, ``input_specs`` and ``decode_cache_abstract`` give the
reference's names, shapes and dtypes as ``Spec`` records (no
allocation).  As in the reference, the decode spec's ``enc_out`` holds
``seq_len // enc_seq_divisor // 16`` frames, where prefill's
``enc_embeds`` hold ``seq_len // enc_seq_divisor``: the spec is carried
as it is, and a caller that decodes against a request's own encoder
output passes the one ``prefill_step`` returned.

``prefill_step`` encodes (for an encoder-decoder config), then prefills
from ``tokens`` or ``embeds`` with ``enc_out``; ``decode_step`` runs one
token for the batch against that ``enc_out``.  Both take a
``models.transformer.Transformer`` on the device of its parameters.

``train_step`` is the train branch of the reference's ``build_step`` on
one device: the batch in ``accum`` microbatches, each microbatch's loss
and gradients (``loss_and_grads``) summed into f32 buffers, their mean
through AdamW (``train/optimizer.update``, in place).

Not carried: ``build_step``'s mesh, shardings, ``BuiltStep`` and buffer
donation, the MoE variants ``ep_ragged``/``fsliced`` and
``paged_attention_local`` (all ``shard_map`` over a mesh: ROADMAP A,
item 6).
"""
from __future__ import annotations

from typing import Any

import torch

from ..models import schema as sc
from ..models.schema import Spec
from ..models import transformer as tf
from ..models.config import ArchConfig, ShapeConfig
from ..train import optimizer as opt


def _specs(tree):
    return sc.map_tree(lambda d: Spec(d.shape, d.dtype), tree)


# ------------------------------------------------------------- input specs
def train_inputs(cfg: ArchConfig, shape: ShapeConfig) -> dict[str, Spec]:
    """Specs of one global training batch."""
    B, S = shape.global_batch, shape.seq_len
    batch: dict[str, Any] = {"labels": Spec((B, S), torch.int32)}
    if cfg.embeds_in:
        batch["embeds"] = Spec((B, S, cfg.d_model), torch.bfloat16)
    else:
        batch["tokens"] = Spec((B, S), torch.int32)
    if cfg.n_enc_layers:
        batch["enc_embeds"] = Spec((B, S // cfg.enc_seq_divisor,
                                    cfg.d_model), torch.bfloat16)
    return batch


def decode_cache_abstract(cfg: ArchConfig, shape: ShapeConfig
                          ) -> tf.DecodeCache:
    """Specs of the decode caches: each layer's pools or mamba states,
    stacked by superblock, block tables [B, PPS] and lengths [B]."""
    B, S, P = shape.global_batch, shape.seq_len, shape.page_size
    pps = S // P
    layers = _specs(sc.stack(cfg.n_superblocks,
                             tf.layer_cache_schema(cfg, B, pps, P)))
    return tf.DecodeCache(layers=layers,
                          block_tables=Spec((B, pps), torch.int32),
                          seq_lens=Spec((B,), torch.int32))


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Every model input of an (arch x shape) cell as specs."""
    if shape.kind == "train":
        return {"batch": train_inputs(cfg, shape)}
    if shape.kind == "prefill":
        b = train_inputs(cfg, shape)
        b.pop("labels")
        return {"batch": b}
    B = shape.global_batch
    spec = {"tokens": Spec((B, 1), torch.int32),
            "cache": decode_cache_abstract(cfg, shape)}
    if cfg.n_enc_layers:
        spec["enc_out"] = Spec((B, shape.seq_len // cfg.enc_seq_divisor
                                // 16, cfg.d_model), torch.bfloat16)
    return spec


# ------------------------------------------------------------ serving steps
def prefill_step(model: tf.Transformer, batch: dict, page_size: int,
                 moe_impl: str = "dense"):
    """Encode ``batch["enc_embeds"]`` where the config has an encoder,
    then prefill from ``batch["tokens"]`` or ``batch["embeds"]``.
    Returns (logits [B, V], DecodeCache, enc_out or None)."""
    enc_out = None
    if model.cfg.n_enc_layers:
        enc_out = model.encode(batch["enc_embeds"])
    logits, cache = model.prefill(batch.get("tokens"), page_size,
                                  moe_impl=moe_impl,
                                  embeds=batch.get("embeds"),
                                  enc_out=enc_out)
    return logits, cache, enc_out


def decode_step(model: tf.Transformer, cache: tf.DecodeCache, tokens,
                page_size: int, enc_out=None, attn=None):
    """One decode token for the batch (the pools updated in place).
    Returns (logits [B, V], DecodeCache with seq_lens + 1)."""
    return model.decode_step(cache, tokens, page_size, attn,
                             enc_out=enc_out)


# --------------------------------------------------------------- train step
def loss_and_grads(params, cfg: ArchConfig, batch: dict,
                   moe_impl: str = "dense", remat: bool = True):
    """``lm_loss`` and its gradient for every leaf of ``params`` (each in
    the leaf's dtype, zeros for a leaf the batch does not reach, such as
    ``embed`` under ``embeds``), in ``schema.flatten``'s order.  Marks the
    leaves as requiring grad.  Returns (loss, [grad])."""
    leaves = sc.flatten(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = tf.lm_loss(params, cfg, batch, moe_impl=moe_impl, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), list(grads)


def train_step(params, opt_state: opt.OptState, batch: dict,
               cfg: ArchConfig, opt_cfg: opt.AdamWConfig, accum: int = 4,
               moe_impl: str = "dense"):
    """One optimizer step over a global batch (numpy arrays or tensors;
    moved to the parameters' device).  With ``accum`` microbatches (1
    when ``accum`` does not divide the batch), each one's gradients, in
    the parameters' dtype, are summed into f32 buffers and divided by
    ``accum``, as the reference's ``gsum``; the loss is the microbatches'
    mean.  Parameters and optimizer state are updated in place.
    Returns (params, OptState, {"loss", "gnorm"})."""
    device = sc.flatten(params)[0].device
    batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    B = next(iter(batch.values())).shape[0]
    accum = accum if B % accum == 0 else 1
    mb = B // accum
    gsum = [torch.zeros(t.shape, dtype=torch.float32, device=device)
            for t in sc.flatten(params)]
    losses = []
    for i in range(accum):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, grads = loss_and_grads(params, cfg, micro, moe_impl)
        for a, g in zip(gsum, grads):
            a.add_(g.to(torch.float32))
        losses.append(loss)
        del grads
    for a in gsum:
        a.div_(accum)
    params, opt_state, gnorm = opt.update(
        opt_cfg, sc.unflatten(params, gsum), opt_state, params)
    return params, opt_state, {"loss": torch.stack(losses).mean(),
                               "gnorm": gnorm}
