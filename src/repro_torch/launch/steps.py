"""Input specs, the one-device steps and ``build_step`` on a mesh for
every (arch x shape) cell (port of ``repro.launch.steps``).

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

``build_step`` builds the train, prefill or decode step of a cell on a
``DeviceMesh`` (one process per device; ``torch.distributed`` initialised
by the caller) and returns a ``BuiltStep``: the function, its arguments'
specs, their placements (``schema.shardings`` of the rules of
``distributed/sharding.make_rules``: a placement tuple where the
reference has a ``NamedSharding``) and ``donate_argnums``.  Its arguments
are DTensors laid out by ``in_shardings`` (``schema.place``).  Each rank
runs the model on its rows of the batch (the ``batch`` rule) with every
parameter leaf gathered whole at its use, as GSPMD's FSDP gathers:

  * the train step gathers the parameters once a step
    (``DTensor.full_tensor``) and the batch's token ids (each microbatch
    is the global rows ``i*mb .. (i+1)*mb``, as the reference's reshape
    makes it; each rank takes its slice).  A rank's loss is the mean over
    its own rows weighted by its share of the global labels, so that the
    sum over the batch axes is the global mean; gradients of the gathered
    leaves accumulate in f32 over the microbatches and are then summed
    over the batch axes into each leaf's placements (``Partial`` ->
    ``Shard``/``Replicate``: a reduce-scatter or an all-reduce).  They are
    not summed over the model axis, where every rank computed the same.
    A leaf that a ``shard_map`` body consumes (the MoE weights under
    ``ep_ragged``/``fsliced``) comes out of the body in pieces and is
    summed at the map's boundary over the axes its spec leaves out, as
    JAX transposes ``shard_map``; it is not summed again.  ``gnorm`` is
    taken over the whole tree; AdamW updates each rank's shards of the
    parameters and of ``mu``/``nu`` in place;
  * prefill and decode gather the parameters; decode keeps each KV pool's
    shard where it lies under ``decode_impl="local"``
    (``distributed/paged_attention.paged_attention_local``, the pools
    written in place), and under ``"gather"`` gathers each pool whole,
    attends and writes the rank's shard back, as a global gather does.

Donation becomes the in-place update: parameters and optimizer state in
train, the cache in decode, the arguments ``donate_argnums`` names.  The
reference's ``attn_backend`` and ``unroll`` have no counterpart (the
port's attention is the kernel on CUDA, its plain version on the CPU; it
loops over superblocks eagerly).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..compat import PartitionSpec as P, _names, full_value, mesh_sizes, \
    placements, psum
from ..distributed.paged_attention import paged_attention_local
from ..distributed.sharding import (ShardingPolicy, batch_shardings,
                                    make_rules, named)
from ..models import moe as me
from ..models import schema as sc
from ..models.schema import Spec
from ..models import transformer as tf
from ..models.config import ArchConfig, ShapeConfig
from ..train import optimizer as opt


@dataclasses.dataclass
class BuiltStep:
    fn: Any
    abstract_args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple


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


def decode_cache_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh,
                           rules: dict) -> tf.DecodeCache:
    """Placements of ``decode_cache_abstract``'s leaves on ``mesh``."""
    B, S, P_ = shape.global_batch, shape.seq_len, shape.page_size
    pps = S // P_
    layers = sc.shardings(
        sc.stack(cfg.n_superblocks, tf.layer_cache_schema(cfg, B, pps, P_)),
        rules, mesh)
    b = rules.get("batch")
    return tf.DecodeCache(layers=layers,
                          block_tables=named(mesh, b, None),
                          seq_lens=named(mesh, b))


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


# ------------------------------------------------------------ mesh steps
def _rows(mesh, axes) -> tuple[int, int]:
    """(this rank's index, the count) of the row shards over ``axes``,
    major to minor."""
    sizes = mesh_sizes(mesh)
    index, count = 0, 1
    for a in axes:
        index = index * sizes[a] + mesh.get_local_rank(a)
        count *= sizes[a]
    return index, count


def _local(x, mesh, pl):
    """This rank's block of a DTensor (or a plain tensor's value) under
    placements ``pl``."""
    if not isinstance(x, DTensor):
        return x
    if tuple(x.placements) != tuple(pl):
        x = x.redistribute(mesh, pl)
    return x.to_local()


def _same_memory(a, b) -> bool:
    """Whether tensors ``a`` and ``b`` are one block of memory: one
    storage, offset, shape and strides.  (Decided without ``data_ptr``,
    which a fake tensor does not give: the dry run traces these steps
    under ``FakeTensorMode``.)"""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset()
            and a.shape == b.shape and a.stride() == b.stride())


def _write_back(view, x, mesh, view_pl) -> None:
    """``view`` (a rank's block of DTensor ``x`` under ``view_pl``, updated
    in place) back into ``x``'s own block, where it is not that block."""
    block = x.to_local()
    if _same_memory(view, block):
        return
    block.copy_(DTensor.from_local(view, mesh, list(view_pl),
                                   run_check=False)
                .redistribute(mesh, x.placements).to_local())


def _as_rows(x, mesh, b):
    """A rank's rows (the ``batch`` rule ``b`` on dim 0) as a DTensor."""
    return DTensor.from_local(x, mesh, list(named(mesh, b,
                                                  *[None] * (x.ndim - 1))),
                              run_check=False)


def _local_moe(fn, mesh, b):
    """A mesh MoE variant on this rank's rows: ``x`` [rows, S, d] is the
    rank's block of the global activation."""
    def moe(p, x, cfg):
        return fn(p, _as_rows(x, mesh, b), cfg).to_local()
    return moe


def _local_attn(mesh, rules: dict, page_size: int, dp_axes):
    """``decode_attention``'s ``local_impl``: the rank's rows and its
    blocks of the layer's pools through ``paged_attention_local``."""
    b = rules.get("batch")
    kv_pl = placements(P(rules.get("kv_pages"), None, rules.get("kv_heads"),
                         rules.get("head_dim")), mesh)
    rows_pl = named(mesh, b, None, None)
    attn = functools.partial(
        paged_attention_local, mesh=mesh, batch_axes=dp_axes,
        kv_head_axis=rules["kv_heads"], head_dim_axis=rules["head_dim"],
        page_size=page_size)

    def local_impl(q, k_pages, v_pages, bt, lens, start, k_new, v_new, *,
                   scale, softcap):
        def pool(t):
            return DTensor.from_local(t, mesh, list(kv_pl), run_check=False)
        out, kp, vp = attn(
            _as_rows(q, mesh, b), pool(k_pages), pool(v_pages),
            _as_rows(bt, mesh, b), _as_rows(lens, mesh, b),
            _as_rows(start, mesh, b), _as_rows(k_new, mesh, b),
            _as_rows(v_new, mesh, b), scale=scale, softcap=softcap)
        for pool_, new in ((k_pages, kp), (v_pages, vp)):
            if not _same_memory(new.to_local(), pool_):
                pool_.copy_(_local(new, mesh, kv_pl))  # not written in place
        return _local(out, mesh, rows_pl), k_pages, v_pages
    return local_impl


def _view_spec(logical, b) -> P:
    """The mesh spec of a cache leaf as a rank computes on it: its batch
    (or page) dimension on the ``batch`` rule's axes, all else whole."""
    return P(*(b if ax in ("batch", "kv_pages") else None for ax in logical))


def _moe_leaves(cfg: ArchConfig, params) -> set:
    """ids of the MoE leaves (router and experts) of ``params``."""
    kinds = tf.layer_kinds(cfg)
    return {id(t) for j, (_, ffn) in enumerate(kinds) if ffn == "moe"
            for t in sc.flatten(params["blocks"][f"l{j}"]["ffn"])}


def build_step(cfg: ArchConfig, shape: ShapeConfig, mesh,
               policy: ShardingPolicy = ShardingPolicy(),
               moe_impl: str = "dense",
               opt_cfg: opt.AdamWConfig = opt.AdamWConfig(),
               grad_accum: int = 4) -> BuiltStep:
    """The train, prefill or decode step (``shape.kind``) of a cell on
    ``mesh`` (see the module docstring).  ``moe_impl``: "dense", "ragged",
    "ep_ragged" (needs ``policy.expert_parallel`` and E % model == 0) or
    "fsliced"."""
    rules = make_rules(cfg, mesh, shape, policy)
    params_abs = _specs(tf.schema(cfg))
    params_sh = sc.shardings(tf.schema(cfg), rules, mesh)
    dp_axes = ("pod", "data") if "pod" in mesh.mesh_dim_names \
        else ("data",)
    n_data = 1
    for a in dp_axes:
        n_data *= mesh_sizes(mesh)[a]
    b = rules.get("batch")
    row_axes = _names(b)

    sharded_moe = moe_impl in ("ep_ragged", "fsliced")
    if moe_impl == "ep_ragged":
        if rules["expert"] != "model":
            raise ValueError("ep_ragged needs ShardingPolicy("
                             "expert_parallel=True) and E % model == 0")
        moe_impl = _local_moe(functools.partial(
            me.moe_ep_ragged, mesh=mesh, dp_axes=dp_axes), mesh, b)
    elif moe_impl == "fsliced":
        moe_impl = _local_moe(functools.partial(
            me.moe_fsliced_ragged, mesh=mesh, dp_axes=dp_axes), mesh, b)
    attn_local = None
    if policy.decode_impl == "local" and shape.kind == "decode" \
            and shape.global_batch % n_data == 0:
        attn_local = _local_attn(mesh, rules, shape.page_size, dp_axes)

    if shape.kind == "train":
        batch_abs = train_inputs(cfg, shape)
        batch_sh = batch_shardings(cfg, mesh, rules, batch_abs)
        opt_sh = opt.OptState(step=named(mesh), mu=params_sh, nu=params_sh)

        def train_step(params, opt_state, batch):
            batch = {k: full_value(v) for k, v in batch.items()}
            B = next(iter(batch.values())).shape[0]
            accum = grad_accum if B % grad_accum == 0 else 1
            mb = B // accum
            r, n_rows = _rows(mesh, row_axes)
            if mb % n_rows:
                raise ValueError(f"a microbatch of {mb} rows does not "
                                 f"divide over {n_rows} row shards")
            lo = r * (mb // n_rows)
            with torch.no_grad():
                full = sc.map_tree(lambda t: full_value(t).detach()
                                   .requires_grad_(True), params)
            leaves = sc.flatten(full)
            gsum = [torch.zeros(t.shape, dtype=torch.float32,
                                device=t.device) for t in leaves]
            losses = []
            for i in range(accum):
                micro = {k: v[i * mb + lo:i * mb + lo + mb // n_rows]
                         for k, v in batch.items()}
                count = (micro["labels"] >= 0).sum().to(torch.float32)
                total = psum(count, mesh, row_axes) if row_axes else count
                loss = tf.lm_loss(full, cfg, micro, moe_impl=moe_impl) \
                    * (count / total.clamp(min=1.0))
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
                for a, g in zip(gsum, grads):
                    a.add_(g.to(torch.float32))
                losses.append(loss.detach())
                del grads
            loss = torch.stack(losses)
            if row_axes:
                loss = psum(loss, mesh, row_axes)
            # each leaf's gradient summed over the row axes into its
            # placements; a shard_map's leaves were summed at its boundary
            reduced = _moe_leaves(cfg, full) if sharded_moe else set()
            grads = []
            for t, g, p in zip(leaves, gsum, sc.flatten(params)):
                g.div_(accum)
                pl = [Partial() if n in row_axes and id(t) not in reduced
                      else Replicate() for n in mesh.mesh_dim_names]
                grads.append(DTensor.from_local(g, mesh, pl, run_check=False)
                             .redistribute(mesh, p.placements))
            del full, leaves, gsum
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g)).full_tensor()
                                   for g in grads))
            local = sc.map_tree(lambda t: t.to_local(), params)
            state = opt.OptState(
                step=opt_state.step,
                mu=sc.map_tree(lambda t: t.to_local(), opt_state.mu),
                nu=sc.map_tree(lambda t: t.to_local(), opt_state.nu))
            _, new, _ = opt.update(
                opt_cfg, sc.unflatten(local, [g.to_local() for g in grads]),
                state, local, gnorm=gnorm)
            return params, opt.OptState(step=new.step, mu=opt_state.mu,
                                        nu=opt_state.nu), \
                {"loss": loss.mean(), "gnorm": gnorm}

        scalars = {"loss": named(mesh), "gnorm": named(mesh)}
        return BuiltStep(
            fn=train_step,
            abstract_args=(params_abs, opt.abstract_state(params_abs),
                           batch_abs),
            in_shardings=(params_sh, opt_sh, batch_sh),
            out_shardings=(params_sh, opt_sh, scalars),
            donate_argnums=(0, 1))

    vshard = rules.get("vocab")
    rows_pl = named(mesh, b, None)
    if shape.kind == "prefill":
        batch_abs = input_specs(cfg, shape)["batch"]
        batch_sh = batch_shardings(cfg, mesh, rules, batch_abs)
        cache_sh = decode_cache_shardings(cfg, shape, mesh, rules)
        pps = shape.seq_len // shape.page_size
        cache_logical = sc.logical_specs(sc.stack(
            cfg.n_superblocks, tf.layer_cache_schema(
                cfg, shape.global_batch, pps, shape.page_size)))

        @torch.no_grad()
        def prefill_step(params, batch):
            full = sc.gather(params)
            batch = {k: _local(v, mesh, batch_sh[k])
                     for k, v in batch.items()}
            enc_out = None
            if cfg.n_enc_layers:
                enc_out = tf.encode(full, cfg, batch["enc_embeds"])
            logits, cache = tf.prefill(
                full, cfg, batch.get("tokens"), shape.page_size,
                moe_impl=moe_impl, embeds=batch.get("embeds"),
                enc_out=enc_out)
            r, _ = _rows(mesh, row_axes)
            bt = cache.block_tables + r * cache.block_tables.numel()
            layers = sc.map_tree(
                lambda t, lg, pl: DTensor.from_local(
                    t, mesh, list(placements(_view_spec(lg, b), mesh)),
                    run_check=False).redistribute(mesh, pl),
                cache.layers, cache_logical, cache_sh.layers)
            return (DTensor.from_local(logits, mesh, list(rows_pl),
                                       run_check=False)
                    .redistribute(mesh, named(mesh, b, vshard)),
                    tf.DecodeCache(layers,
                                   DTensor.from_local(bt, mesh, list(rows_pl),
                                                      run_check=False),
                                   _as_rows(cache.seq_lens, mesh, b)))

        return BuiltStep(
            fn=prefill_step,
            abstract_args=(params_abs, batch_abs),
            in_shardings=(params_sh, batch_sh),
            out_shardings=(named(mesh, b, vshard), cache_sh),
            donate_argnums=())

    # ---- decode ----------------------------------------------------------
    specs = input_specs(cfg, shape)
    cache_sh = decode_cache_shardings(cfg, shape, mesh, rules)
    pps = shape.seq_len // shape.page_size
    cache_logical = sc.logical_specs(sc.stack(
        cfg.n_superblocks, tf.layer_cache_schema(
            cfg, shape.global_batch, pps, shape.page_size)))

    def view_pl(logical):
        if logical[1] == "kv_pages":         # a KV pool, stacked
            if attn_local is not None:
                return None                  # its own block, as it lies
            return named(mesh)               # whole: global page ids
        return placements(_view_spec(logical, b), mesh)

    @torch.no_grad()
    def decode_step(params, cache, tokens, enc_out=None):
        full = sc.gather(params)
        vpl = sc.map_tree(view_pl, cache_logical)
        views = sc.map_tree(
            lambda t, pl: t.to_local() if pl is None
            else _local(t, mesh, pl), cache.layers, vpl)
        lens = _local(cache.seq_lens, mesh, named(mesh, b))
        logits, _ = tf.decode_step(
            full, cfg, tf.DecodeCache(
                views, _local(cache.block_tables, mesh, rows_pl), lens),
            _local(tokens, mesh, rows_pl), shape.page_size,
            enc_out=None if enc_out is None
            else _local(enc_out, mesh, named(mesh, b, None, None)),
            attn_local_impl=attn_local)
        sc.map_tree(lambda v, t, pl: pl is None
                    or _write_back(v, t, mesh, pl), views, cache.layers, vpl)
        return (DTensor.from_local(logits, mesh, list(rows_pl),
                                   run_check=False)
                .redistribute(mesh, named(mesh, b, vshard)),
                tf.DecodeCache(cache.layers, cache.block_tables,
                               _as_rows(lens + 1, mesh, b)))

    args = (params_abs, specs["cache"], specs["tokens"])
    shards = (params_sh, cache_sh, rows_pl)
    if cfg.n_enc_layers:
        args = args + (specs["enc_out"],)
        shards = shards + (named(mesh, b, None, None),)
    return BuiltStep(
        fn=decode_step,
        abstract_args=args,
        in_shardings=shards,
        out_shardings=(named(mesh, b, vshard), cache_sh),
        donate_argnums=(1,))
