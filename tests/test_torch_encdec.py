"""The port's encoder-decoder and embedding-input models held to the JAX
reference at the smoke configs of seamless-m4t-medium (encoder-decoder,
G = 1) and pixtral-12b (embedding inputs, G = 2): cross attention, the
encoder, the full forward, prefill and paged decode with ``embeds`` and
``enc_out``, the reference's parameters carried by
``schema.from_numpy``; and ``launch/steps.py``'s specs and serving steps
against the reference's ``launch/steps.py``.

Tolerances are ``tests/test_torch_models.py``'s: f32 1e-5 on single
layers, 1e-4 on whole-model logits, bf16 5e-2.  Inputs are made from a
seed with numpy."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: breaks an import cycle)
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.launch import steps as jsteps
from repro.models import layers as jll
from repro.models import transformer as jtf
from repro.models.config import LM_SHAPES as JLM_SHAPES
from repro.models.config import ShapeConfig as JShapeConfig
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import layers as tll
from repro_torch.models import schema as tsc
from repro_torch.models import transformer as ttf
from repro_torch.models.config import LM_SHAPES, ShapeConfig, shape_by_name
from test_torch_cuda import _decode_room
from test_torch_models import (BF16_TOL, F32_TOL, LOGIT_TOL, _check_prefill,
                               _flat, _np, _random_caches, reference_params)

SEAMLESS, PIXTRAL = "seamless_m4t_medium", "pixtral_12b"


def _normal(rng, shape, bf16=False):
    """Seeded normal inputs, bf16-representable when ``bf16``."""
    a = rng.normal(size=shape).astype(np.float32)
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) if bf16 \
        else a


def _pair(a, dtype):
    """The same numpy array for the reference and the port, in ``dtype``
    (np.float32, or None for bf16)."""
    if dtype is None:
        return jnp.asarray(a, jnp.bfloat16), \
            torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------- cross attention
@pytest.mark.parametrize("dtype", [np.float32, None], ids=["f32", "bf16"])
@pytest.mark.parametrize("lens", [None, [5, 11]], ids=["full", "ctx_lens"])
@pytest.mark.parametrize("arch", [SEAMLESS, PIXTRAL], ids=["G1", "G2"])
def test_cross_attention_matches_reference(arch, lens, dtype):
    """Queries from x, keys and values from ctx, no RoPE, no causal mask,
    keys at or past ``ctx_lens`` masked; G = 1 on seamless's cross
    attention, G = 2 on pixtral's attention weights (the same schema)."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    assert cfg.q_per_kv == (1 if arch == SEAMLESS else 2)
    jp, npt = reference_params(arch, dtype)
    leaf = "xattn" if arch == SEAMLESS else "attn"
    lp = jax.tree.map(lambda a: a[0], jp["blocks"]["l0"][leaf])
    tp = tsc.from_numpy(jax.tree.map(lambda a: a[0],
                                     npt["blocks"]["l0"][leaf]))
    rng = np.random.default_rng(7)
    bf16 = dtype is None
    jx, tx = _pair(_normal(rng, (2, 9, 64), bf16), dtype)
    jc, tc = _pair(_normal(rng, (2, 12, 64), bf16), dtype)
    jl = tl = None
    if lens is not None:
        jl, tl = jnp.asarray(lens, jnp.int32), torch.tensor(
            lens, dtype=torch.int32)
    want = jll.cross_attention(lp, jx, jc, jcfg, ctx_lens=jl)
    got = tll.cross_attention(tp, tx, tc, cfg, ctx_lens=tl)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(F32_TOL if dtype else BF16_TOL))
    if lens is not None:    # the masked keys change nothing
        cut = tc.clone()
        cut[0, lens[0]:] = 7.0
        torch.testing.assert_close(
            tll.cross_attention(tp, tx, cut, cfg, ctx_lens=tl), got)


def test_encoder_self_attention_is_not_causal_attention():
    """The encoder's self-attention is the cross primitive with ctx = x:
    no RoPE and no causal mask, so the prefill attention (causal, RoPE)
    gives other outputs on the same weights; only the last query, which
    sees every key in both, at position 0 (RoPE's identity) would agree."""
    cfg = get_smoke_config(SEAMLESS)
    _, npt = reference_params(SEAMLESS)
    tp = tsc.from_numpy(jax.tree.map(lambda a: a[0],
                                     npt["enc_blocks"]["attn"]))
    x = torch.from_numpy(_normal(np.random.default_rng(8), (1, 10, 64)))
    cross = tll.cross_attention(tp, x, x, cfg)
    causal, _ = tll.attention(tp, x, cfg, local=False)
    assert (cross - causal).abs().amax(dim=-1).min() > 1e-3


# ------------------------------------------------------------------ encoder
@pytest.mark.parametrize("dtype", [np.float32, None], ids=["f32", "bf16"])
def test_encode_matches_reference(dtype):
    cfg, jcfg = get_smoke_config(SEAMLESS), jget_smoke(SEAMLESS)
    jp, npt = reference_params(SEAMLESS, dtype)
    tp = tsc.from_numpy(npt)
    jx, tx = _pair(_normal(np.random.default_rng(9), (2, 12, 64)), dtype)
    want = jtf.encode(jp, jcfg, jx, remat=False)
    got = ttf.encode(tp, cfg, tx)
    assert got.dtype == tp["lm_head"].dtype and got.shape == (2, 12, 64)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(F32_TOL if dtype else BF16_TOL))
    torch.testing.assert_close(ttf.Transformer(cfg, tp).encode(tx), got,
                               rtol=0, atol=0)


def _inputs(arch, rng, B=2, S=32):
    """(tokens, embeds or None, enc_embeds or None) for ``arch``."""
    cfg = get_smoke_config(arch)
    toks = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    emb = _normal(rng, (B, S, cfg.d_model)) if cfg.embeds_in else None
    enc = _normal(rng, (B, S // cfg.enc_seq_divisor, cfg.d_model)) \
        if cfg.n_enc_layers else None
    return toks, emb, enc


def _model_args(jp, tp, jcfg, cfg, toks, emb, enc):
    """The reference's and the port's keyword arguments: tokens or
    embeds, and the encoder output of ``enc`` where given."""
    jkw, tkw = {}, {}
    if emb is None:
        jkw["tokens"], tkw["tokens"] = jnp.asarray(toks), \
            torch.from_numpy(toks)
    else:
        jkw["embeds"], tkw["embeds"] = jnp.asarray(emb), \
            torch.from_numpy(emb)
    if enc is not None:
        jkw["enc_out"] = jtf.encode(jp, jcfg, jnp.asarray(enc), remat=False)
        tkw["enc_out"] = ttf.encode(tp, cfg, torch.from_numpy(enc))
    return jkw, tkw


# --------------------------------------------------- forward and prefill
# pixtral in f32 and bf16; seamless in f32.  Its smoke model's bf16 logits
# sit at BF16_TOL's edge even from tokens alone (the frameworks round bf16
# activations at other steps: one smoke MLP layer's outputs differ by an
# ulp in 2,601 of 4,096 places; over parameter seeds 0-5 the largest
# excess over the tolerance reached 0.0025 without an encoder output and
# 0.0114 with it), so, as for mamba2 and jamba in
# tests/test_torch_models.py, its
# whole model is held in f32 and its layers (cross attention, encode,
# decode steps) in bf16 as well.
@pytest.mark.parametrize("arch,dtype", [(PIXTRAL, np.float32),
                                        (PIXTRAL, None),
                                        (SEAMLESS, np.float32)],
                         ids=["pixtral-f32", "pixtral-bf16", "seamless-f32"])
def test_forward_and_prefill_match_reference(arch, dtype):
    """pixtral from ``embeds``, seamless with ``enc_out``: the full
    forward's logits, then prefill's last-position logits (``last_pos``
    [29, 31] of 32), tables and every KV pool."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp, npt = reference_params(arch, dtype)
    tp = tsc.from_numpy(npt)
    toks, emb, enc = _inputs(arch, np.random.default_rng(10))
    jkw, tkw = _model_args(jp, tp, jcfg, cfg, toks, emb, enc)
    tol = LOGIT_TOL if dtype else BF16_TOL
    want = jtf.forward(jp, jcfg, remat=False, **jkw)
    got = ttf.forward(tp, cfg, **tkw)
    np.testing.assert_allclose(_np(got), np.asarray(want), **tol)
    last = np.asarray([29, 31], np.int32)
    wl, wc = jtf.prefill(jp, jcfg, page_size=8, remat=False,
                         last_pos=jnp.asarray(last), **jkw)
    gl, gc = ttf.prefill(tp, cfg, page_size=8, last_pos=torch.from_numpy(
        last), **tkw)
    _check_prefill(jp, jcfg, toks, last, wl, wc, gl, gc, tol)


@pytest.mark.parametrize("dtype", [np.float32, None], ids=["f32", "bf16"])
def test_forward_from_embeds_of_tokens_equals_tokens(dtype):
    """``forward(embeds=embed[tokens])`` is ``forward(tokens)`` bit for
    bit, in the port as in the reference (``embed`` and ``lm_head`` share
    a dtype)."""
    cfg, jcfg = get_smoke_config(PIXTRAL), jget_smoke(PIXTRAL)
    jp, npt = reference_params(PIXTRAL, dtype)
    tp = tsc.from_numpy(npt)
    toks = np.random.default_rng(11).integers(1, cfg.vocab, (2, 24)) \
        .astype(np.int32)
    t = torch.from_numpy(toks)
    torch.testing.assert_close(
        ttf.forward(tp, cfg, embeds=tp["embed"][t.long()]),
        ttf.forward(tp, cfg, t), rtol=0, atol=0)
    np.testing.assert_array_equal(
        np.asarray(jtf.forward(jp, jcfg, embeds=jp["embed"][toks],
                               remat=False)),
        np.asarray(jtf.forward(jp, jcfg, tokens=jnp.asarray(toks),
                               remat=False)))


# ------------------------------------------------------------------- decode
@pytest.mark.parametrize("dtype", [np.float32, None], ids=["f32", "bf16"])
def test_decode_step_with_enc_out_matches_reference(dtype):
    """Three decode steps over random pools with ``enc_out`` (the
    reference with its plain attention): two live lanes, one idle lane on
    scratch page 0; logits of the live lanes and every pool page but 0."""
    cfg, jcfg = get_smoke_config(SEAMLESS), jget_smoke(SEAMLESS)
    jp, npt = reference_params(SEAMLESS, dtype)
    tp = tsc.from_numpy(npt)
    rng = np.random.default_rng(12)
    P, pps, NP = 8, 6, 20
    pools = _random_caches(cfg, rng, NP, P, bf16=dtype is None)
    bt = np.zeros((3, pps), np.int32)
    bt[0] = [5, 9, 2, 11, 0, 0]
    bt[2] = [7, 3, 14, 19, 17, 1]
    lens = np.asarray([15, 0, 39], np.int32)
    enc = _normal(rng, (3, 6, cfg.d_model))
    jenc = jtf.encode(jp, jcfg, jnp.asarray(enc), remat=False)
    tenc = ttf.encode(tp, cfg, torch.from_numpy(enc))
    jcache = jtf.DecodeCache(jax.tree.map(jnp.asarray, pools),
                             jnp.asarray(bt), jnp.asarray(lens))
    tcache = ttf.DecodeCache(tsc.from_numpy(pools), torch.from_numpy(bt),
                             torch.from_numpy(lens))
    tol = LOGIT_TOL if dtype else BF16_TOL
    for step in range(3):
        toks = rng.integers(1, cfg.vocab, (3, 1)).astype(np.int32)
        wl, jcache = jtf.decode_step(jp, jcfg, jcache, jnp.asarray(toks),
                                     page_size=P, enc_out=jenc,
                                     attn_backend="ref")
        gl, tcache = ttf.decode_step(tp, cfg, tcache, torch.from_numpy(toks),
                                     P, enc_out=tenc)
        np.testing.assert_allclose(_np(gl)[[0, 2]], np.asarray(wl)[[0, 2]],
                                   **tol, err_msg=f"step {step}")
    for name in pools:
        for kind in pools[name]:
            np.testing.assert_allclose(
                _np(tcache.layers[name][kind])[:, 1:],
                np.asarray(jcache.layers[name][kind], np.float32)[:, 1:],
                **tol, err_msg=f"{name}/{kind}")


# ------------------------------------------------------- launch/steps.py
def _spec_flat(tree, prefix=""):
    """name -> (shape, dtype name) of a spec tree of either package."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and "block_tables" in tree._fields:
        return _spec_flat(tree._asdict(), prefix)
    dt = tree.dtype
    name = str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name
    return {prefix: (tuple(tree.shape), name)}


@pytest.mark.parametrize("shape", [s.name for s in LM_SHAPES])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch, shape):
    """Every config x ``LM_SHAPES``: the same names, shapes and dtypes as
    the reference's ShapeDtypeStructs (no allocation); decode's
    ``enc_out`` keeps the reference's ``// 16`` frames."""
    sh, jsh = shape_by_name(shape), next(s for s in JLM_SHAPES
                                         if s.name == shape)
    cfg, jcfg = get_config(arch), jget_config(arch)
    got, want = steps.input_specs(cfg, sh), jsteps.input_specs(jcfg, jsh)
    assert _spec_flat(got) == _spec_flat(want)
    if sh.kind == "decode":
        assert _spec_flat(steps.decode_cache_abstract(cfg, sh)) == \
            _spec_flat(jsteps.decode_cache_abstract(jcfg, jsh))
        if cfg.n_enc_layers:
            assert got["enc_out"].shape[1] == \
                sh.seq_len // cfg.enc_seq_divisor // 16
    if sh.kind != "decode":
        assert _spec_flat(steps.train_inputs(cfg, sh)) == \
            _spec_flat(jsteps.train_inputs(jcfg, jsh))


def _shapes(tree):
    """name -> shape of a tree of either package (the f32 test's pools
    are f32, where the specs say bf16)."""
    return {k: v[0] for k, v in _spec_flat(tree).items()}


@pytest.mark.parametrize("arch", [PIXTRAL, SEAMLESS])
def test_steps_prefill_and_decode_match_reference(arch):
    """``steps.prefill_step`` + 3 ``steps.decode_step``s against the
    reference's ``tf.encode`` + ``tf.prefill`` + ``tf.decode_step`` (its
    plain attention), in f32: the prefill logits and ``enc_out``, each
    step's logits, in caches of ``decode_cache_abstract``'s shapes with
    prefill's pages copied into each sequence's first pages."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp, npt = reference_params(arch)
    model = ttf.Transformer(cfg, tsc.from_numpy(npt))
    B, S, P = 2, 32, 8
    rng = np.random.default_rng(13)
    toks, emb, enc = _inputs(arch, rng, B, S)
    batch = {"tokens": torch.from_numpy(toks)} if emb is None else \
        {"embeds": torch.from_numpy(emb)}
    if enc is not None:
        batch["enc_embeds"] = torch.from_numpy(enc)
    gl, gc, genc = steps.prefill_step(model, batch, P)
    jenc = None
    if enc is not None:
        jenc = jtf.encode(jp, jcfg, jnp.asarray(enc), remat=False)
        np.testing.assert_allclose(_np(genc), np.asarray(jenc), **F32_TOL)
    else:
        assert genc is None
    wl, wc = jtf.prefill(jp, jcfg, tokens=None if emb is not None
                         else jnp.asarray(toks), embeds=None if emb is None
                         else jnp.asarray(emb), enc_out=jenc, page_size=P,
                         remat=False)
    np.testing.assert_allclose(_np(gl), np.asarray(wl), **LOGIT_TOL)

    shape = ShapeConfig("decode_test", "decode", 2 * S, B, P)
    spec = steps.decode_cache_abstract(cfg, shape)
    room = spec.block_tables.shape[1]
    tcache = ttf.DecodeCache(
        _decode_room(gc.layers, B, S // P, room,
                     lambda t, n: t.new_zeros((t.shape[0], n,
                                               *t.shape[2:]))),
        torch.arange(B * room, dtype=torch.int32).reshape(B, room),
        torch.full((B,), S, dtype=torch.int32))
    assert _shapes(tcache.layers) == _shapes(spec.layers)
    jspec = jsteps.decode_cache_abstract(
        jcfg, JShapeConfig("decode_test", "decode", 2 * S, B, P))
    jcache = jtf.DecodeCache(
        _decode_room(jax.tree.map(np.array, wc.layers), B, S // P, room,
                     lambda t, n: np.zeros((t.shape[0], n, *t.shape[2:]),
                                           t.dtype)),
        jnp.arange(B * room, dtype=jnp.int32).reshape(B, room),
        jnp.full((B,), S, jnp.int32))
    assert _shapes(jcache.layers) == _shapes(jspec.layers)
    jcache = jcache._replace(layers=jax.tree.map(jnp.asarray, jcache.layers))
    for step in range(3):
        nxt = rng.integers(1, cfg.vocab, (B, 1)).astype(np.int32)
        wl, jcache = jtf.decode_step(jp, jcfg, jcache, jnp.asarray(nxt),
                                     page_size=P, enc_out=jenc,
                                     attn_backend="ref")
        gl, tcache = steps.decode_step(model, tcache, torch.from_numpy(nxt),
                                       P, enc_out=genc)
        np.testing.assert_allclose(_np(gl), np.asarray(wl), **LOGIT_TOL,
                                   err_msg=f"step {step}")
    np.testing.assert_array_equal(tcache.seq_lens.numpy(), [S + 3] * B)


# ------------------------------------------------------------ from_numpy
@pytest.mark.parametrize("arch", [SEAMLESS, PIXTRAL])
def test_from_numpy_carries_encdec_leaves(arch):
    """The reference's bf16 tree, leaf for leaf: seamless's
    ``enc_blocks``, ``enc_norm`` and every layer's ``ln_x``/``xattn``
    with no special case; the port's own initializer makes the same tree
    of shapes and dtypes."""
    _, npt = reference_params(arch, dtype=None)
    t = tsc.from_numpy(npt)
    jf, tf_ = _flat(npt), _flat(t)
    assert jf.keys() == tf_.keys()
    enc = {"/enc_norm/scale", "/enc_blocks/attn/wq", "/enc_blocks/mlp/w_up",
           "/blocks/l0/ln_x/scale", "/blocks/l0/xattn/wk"}
    assert enc <= jf.keys() if arch == SEAMLESS else not enc & jf.keys()
    for k in jf:
        assert str(tf_[k].dtype).removeprefix("torch.") == \
            np.dtype(jf[k].dtype).name, k
        np.testing.assert_array_equal(_np(tf_[k]),
                                      np.asarray(jf[k], np.float32), k)
    mine = _flat(tsc.init(ttf.schema(get_smoke_config(arch)),
                          torch.Generator().manual_seed(0), "cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tf_.items()}
