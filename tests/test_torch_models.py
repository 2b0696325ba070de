"""The port's models held to the JAX reference: layers, the full
forward, prefill and paged decode, on the reference's own parameters
carried over by ``schema.from_numpy`` at the smoke configs of the dense
stacks (qwen2.5; gemma2: local/global layers, a sliding window and both
softcaps; gemma3: five local layers to one global; stablelm: MHA), the
MoE models (olmoe, mixtral), mamba2, the hybrid jamba, and pixtral and
seamless from token ids, and the parameter schemas and counts at full
size.

Tolerances: with the parameters cast to f32, 1e-5 on single layers and
1e-4 on whole-model logits (the two frameworks sum in other orders, f32
keeps ~7 digits); with the bf16 parameters as drawn, 5e-2 on logits of
magnitude ~1 (bf16 keeps 8 mantissa bits, and the frameworks round the
activations at other steps).  Inputs are made from a seed with numpy."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: breaks an import cycle)
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import layers as jll
from repro.models import schema as jsc
from repro.models import transformer as jtf
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import layers as tll
from repro_torch.models import schema as tsc
from repro_torch.models import transformer as ttf

F32_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def reference_params(arch, dtype=np.float32, seed=0):
    """The reference's initial parameters for the smoke config: (jax tree,
    numpy tree), cast to ``dtype`` unless it is None (bf16 as drawn)."""
    cfg = jget_smoke(arch)
    params = jsc.init(jtf.schema(cfg), jax.random.key(seed))
    npt = jax.tree.map(np.asarray, params)
    if dtype is not None:
        npt = jax.tree.map(lambda a: a.astype(dtype), npt)
    return jax.tree.map(jnp.asarray, npt), npt


def _np(t):
    return t.detach().float().numpy()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_schema_and_param_count_match_reference(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    assert tcfg == type(tcfg)(**{f: getattr(jcfg, f) for f in
                                 tcfg.__dataclass_fields__})
    jflat = _flat(jtf.schema(jcfg))
    tflat = _flat(ttf.schema(tcfg))
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        assert jflat[k].shape == tflat[k].shape, k
        assert np.dtype(jflat[k].dtype).name == \
            str(tflat[k].dtype).removeprefix("torch."), k
        assert jflat[k].init == tflat[k].init, k
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert ttf.moe_param_count(tcfg) == jtf.moe_param_count(jcfg)
    assert (tcfg.d_inner, tcfg.n_ssm_heads) == (jcfg.d_inner,
                                                jcfg.n_ssm_heads)
    assert get_smoke_config(arch).param_count() == \
        jget_smoke(arch).param_count()
    assert get_smoke_config(arch).active_param_count() == \
        jget_smoke(arch).active_param_count()


@pytest.mark.parametrize("arch", ["pixtral_12b", "seamless_m4t_medium"])
def test_encdec_configs_equal_reference(arch):
    """The embedding-input and encoder-decoder configs, carried: CONFIG
    and SMOKE_CONFIG equal the reference's field for field, and at both
    sizes the schemas (``enc_blocks``, ``enc_norm``, ``ln_x``, ``xattn``
    included) and parameter counts match."""
    for mine, ref in ((get_config(arch), jget_config(arch)),
                      (get_smoke_config(arch), jget_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.n_enc_layers or mine.embeds_in
        jflat, tflat = _flat(jtf.schema(ref)), _flat(ttf.schema(mine))
        assert jflat.keys() == tflat.keys()
        assert {k: jflat[k].shape for k in jflat} == \
            {k: tflat[k].shape for k in tflat}
        assert mine.param_count() == ref.param_count()
        assert ttf.superblock_schema(mine).keys() == \
            jtf.superblock_schema(ref).keys()
    want = {"pixtral_12b": 12_247_782_400, "seamless_m4t_medium": 977_860_608}
    assert get_config(arch).param_count() == want[arch]
    assert get_config(arch).active_param_count() == want[arch]


def test_from_numpy_carries_bf16_leaf_for_leaf():
    _, npt = reference_params("qwen2p5_3b", dtype=None)
    t = tsc.from_numpy(npt)
    jf, tf_ = _flat(npt), _flat(t)
    assert jf.keys() == tf_.keys()
    assert str(jf["/embed"].dtype) == "bfloat16"
    for k in jf:
        assert str(tf_[k].dtype).removeprefix("torch.") == \
            np.dtype(jf[k].dtype).name, k
        np.testing.assert_array_equal(_np(tf_[k]),
                                      np.asarray(jf[k], np.float32), k)
    # the port's own initializer gives the same tree of shapes and types
    cfg = get_smoke_config("qwen2p5_3b")
    mine = _flat(tsc.init(ttf.schema(cfg), torch.Generator().manual_seed(0),
                          "cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tf_.items()}


def test_norm_rope_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 6)).astype(np.int32)
    np.testing.assert_allclose(
        _np(tll.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)),
        np.asarray(jll.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=2e-5)
    jp, npt = reference_params("qwen2p5_3b")
    lp = jax.tree.map(lambda a: a[0], jp["blocks"]["l0"])
    tp = tsc.from_numpy(jax.tree.map(lambda a: a[0], npt["blocks"]["l0"]))
    h = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    np.testing.assert_allclose(
        _np(tll.rmsnorm(tp["ln1"], torch.from_numpy(h))),
        np.asarray(jll.rmsnorm(lp["ln1"], jnp.asarray(h))), **F32_TOL)
    np.testing.assert_allclose(
        _np(tll.mlp(tp["ffn"], torch.from_numpy(h))),
        np.asarray(jll.mlp(lp["ffn"], jnp.asarray(h))), **F32_TOL)


@pytest.mark.parametrize("arch,local,lens,q_chunk", [
    ("qwen2p5_3b", False, None, 4096), ("gemma2_27b", True, None, 4096),
    ("gemma2_27b", False, [40, 17], 4096), ("qwen2p5_3b", False, None, 16)])
def test_attention_matches_reference(arch, local, lens, q_chunk):
    """Global, sliding-window (window 32 of 48) and ``seq_lens`` masks, and
    queries in chunks of 16."""
    cfg = get_smoke_config(arch)
    jp, npt = reference_params(arch)
    lp = jax.tree.map(lambda a: a[0], jp["blocks"]["l0"]["attn"])
    tp = tsc.from_numpy(jax.tree.map(lambda a: a[0],
                                     npt["blocks"]["l0"]["attn"]))
    x = np.random.default_rng(1).normal(size=(2, 48, 64)).astype(np.float32)
    sl = None if lens is None else np.asarray(lens, np.int32)
    want, (wk, wv) = jll.attention(
        lp, jnp.asarray(x), jget_smoke(arch), local=local,
        seq_lens=None if sl is None else jnp.asarray(sl), q_chunk=q_chunk)
    got, (gk, gv) = tll.attention(
        tp, torch.from_numpy(x), cfg, local=local,
        seq_lens=None if sl is None else torch.from_numpy(sl),
        q_chunk=q_chunk)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(_np(gk), np.asarray(wk), **F32_TOL)
    np.testing.assert_allclose(_np(gv), np.asarray(wv), **F32_TOL)


def test_attention_long_prompt_must_fill_its_query_chunks():
    """As in the reference, a prompt longer than ``q_chunk`` must be a
    multiple of it."""
    cfg = get_smoke_config("qwen2p5_3b")
    _, npt = reference_params("qwen2p5_3b")
    tp = tsc.from_numpy(jax.tree.map(lambda a: a[0],
                                     npt["blocks"]["l0"]["attn"]))
    with pytest.raises(RuntimeError):
        tll.attention(tp, torch.zeros(1, 20, 64), cfg, local=False,
                      q_chunk=16)


# every carried family in f32 (pixtral and seamless from tokens, without
# an encoder output, as the engine serves them; their embeddings and
# encoder are held in tests/test_torch_encdec.py); bf16 on the dense
# stacks only.  At the
# smoke widths, rounding silu in the reference's steps (sigmoid, then the
# product) in place of one step moves the port's own bf16 mamba2 and
# jamba logits beyond BF16_TOL: their layers are held in bf16 instead
# (tests/test_torch_mamba2.py, tests/test_torch_moe.py).
F32_ARCHS = [("qwen2p5_3b", np.float32), ("gemma2_27b", np.float32),
             ("gemma3_12b", np.float32), ("stablelm_3b", np.float32),
             ("olmoe_1b_7b", np.float32), ("mixtral_8x22b", np.float32),
             ("mamba2_1p3b", np.float32), ("jamba_v0p1_52b", np.float32),
             ("pixtral_12b", np.float32), ("seamless_m4t_medium", np.float32)]


def _check_prefill(jp, jcfg, toks, last, wl, wc, gl, gc, tol,
                   moe_impl="dense"):
    """Logits, tables, KV pages and mamba states of a prefill with
    ``last`` = [29, 31] of 32 tokens.  The port takes a mamba state after
    each row's ``last`` position, the reference after the last one: row 1
    is held to the reference's prefill, row 0 to the reference's prefill
    of its 30 tokens alone.  The KV pools are compared whole, but in a
    stack with mamba layers: past a row's last position (its pad tail,
    which decode overwrites before reading), a layer after a mamba layer
    sees other inputs, so there KV pages are compared up to it."""
    np.testing.assert_allclose(_np(gl), np.asarray(wl), **tol)
    np.testing.assert_array_equal(gc.block_tables.numpy(),
                                  np.asarray(wc.block_tables))
    np.testing.assert_array_equal(gc.seq_lens.numpy(),
                                  np.asarray(wc.seq_lens))
    assert gc.layers.keys() == wc.layers.keys()
    short = None
    mamba = "M" in jcfg.pattern
    for name in wc.layers:
        assert gc.layers[name].keys() == wc.layers[name].keys()
        for kind, want in wc.layers[name].items():
            got = _np(gc.layers[name][kind])
            want = np.asarray(want, np.float32)
            if kind in ttf.KV_LEAVES and not mamba:
                np.testing.assert_allclose(got, want, **tol,
                                           err_msg=f"{name}/{kind}")
                continue
            if kind in ttf.KV_LEAVES:
                B, S = toks.shape
                got = got.reshape(got.shape[0], B, S, *got.shape[3:])
                want = want.reshape(got.shape)
                for row in range(B):
                    n = int(last[row]) + 1
                    np.testing.assert_allclose(got[:, row, :n],
                                               want[:, row, :n], **tol)
                continue
            np.testing.assert_allclose(got[:, 1], want[:, 1], **tol,
                                       err_msg=f"{name}/{kind}")
            if short is None:
                n = int(last[0]) + 1
                short = jtf.prefill(jp, jcfg, tokens=jnp.asarray(
                    toks[:1, :n]), page_size=n, remat=False,
                    moe_impl=moe_impl)[1]
            np.testing.assert_allclose(
                got[:, 0], np.asarray(short.layers[name][kind],
                                      np.float32)[:, 0], **tol,
                err_msg=f"{name}/{kind} at the last real token")


@pytest.mark.parametrize("arch,dtype", F32_ARCHS[:2] + [
    ("qwen2p5_3b", None)] + F32_ARCHS[2:])
def test_forward_and_prefill_match_reference(arch, dtype):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp, npt = reference_params(arch, dtype)
    tp = tsc.from_numpy(npt)
    toks = np.random.default_rng(2).integers(1, cfg.vocab, (2, 32)) \
        .astype(np.int32)
    tol = LOGIT_TOL if dtype is not None else BF16_TOL
    want = jtf.forward(jp, jcfg, tokens=jnp.asarray(toks), remat=False)
    got = ttf.forward(tp, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), np.asarray(want), **tol)

    last = np.asarray([29, 31], np.int32)
    wl, wc = jtf.prefill(jp, jcfg, tokens=jnp.asarray(toks), page_size=8,
                         remat=False, last_pos=jnp.asarray(last))
    gl, gc = ttf.prefill(tp, cfg, torch.from_numpy(toks), 8,
                         torch.from_numpy(last))
    _check_prefill(jp, jcfg, toks, last, wl, wc, gl, gc, tol)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mixtral_8x22b",
                                  "jamba_v0p1_52b"])
def test_forward_and_prefill_with_ragged_moe_match_reference(arch):
    """``moe_impl="ragged"`` through the whole model, in f32."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp, npt = reference_params(arch)
    tp = tsc.from_numpy(npt)
    toks = np.random.default_rng(5).integers(1, cfg.vocab, (2, 32)) \
        .astype(np.int32)
    want = jtf.forward(jp, jcfg, tokens=jnp.asarray(toks), remat=False,
                       moe_impl="ragged")
    got = ttf.forward(tp, cfg, torch.from_numpy(toks), moe_impl="ragged")
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
    last = np.asarray([29, 31], np.int32)
    wl, wc = jtf.prefill(jp, jcfg, tokens=jnp.asarray(toks), page_size=8,
                         remat=False, last_pos=jnp.asarray(last),
                         moe_impl="ragged")
    gl, gc = ttf.prefill(tp, cfg, torch.from_numpy(toks), 8,
                         torch.from_numpy(last), moe_impl="ragged")
    _check_prefill(jp, jcfg, toks, last, wl, wc, gl, gc, LOGIT_TOL,
                   "ragged")


def _random_caches(cfg, rng, NP, P, bf16):
    """Seeded decode caches for every layer of ``cfg``: KV pools of NP
    pages (bf16-representable when ``bf16``), mamba states of 3 rows."""
    out = {}
    for i, (kind, _) in enumerate(ttf.layer_kinds(cfg)):
        if kind == "M":
            C = cfg.d_inner + 2 * cfg.ssm_state
            shapes = {"ssm": (3, cfg.n_ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state),
                      "conv": (3, cfg.conv_width - 1, C)}
        else:
            kv = (NP, P, cfg.n_kv_heads, cfg.head_dim)
            shapes = {"k_pages": kv, "v_pages": kv}
        out[f"l{i}"] = {}
        for name, shape in shapes.items():
            a = rng.normal(size=(cfg.n_superblocks, *shape)).astype(
                np.float32)
            if bf16 and name in ttf.KV_LEAVES:
                a = np.asarray(jnp.asarray(a, jnp.bfloat16))
            out[f"l{i}"][name] = a
    return out


@pytest.mark.parametrize("arch,dtype", F32_ARCHS[:2] + [
    ("gemma2_27b", None)] + F32_ARCHS[2:])
def test_decode_step_matches_reference(arch, dtype):
    """Three decode steps over random pools and mamba states: two live
    lanes (one crossing a page edge, one past gemma2's window of 32) and
    one idle lane whose table points at scratch page 0.  Logits of the
    live lanes, every pool page but 0 (where the idle lanes collide) and
    the mamba states of the live lanes, updated in place, must agree."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp, npt = reference_params(arch, dtype)
    tp = tsc.from_numpy(npt)
    rng = np.random.default_rng(3)
    P, pps, NP = 8, 6, 20
    pools = _random_caches(cfg, rng, NP, P, bf16=dtype is None)
    bt = np.zeros((3, pps), np.int32)
    bt[0] = [5, 9, 2, 11, 0, 0]
    bt[2] = [7, 3, 14, 19, 17, 1]
    lens = np.asarray([15, 0, 39], np.int32)
    jcache = jtf.DecodeCache(jax.tree.map(jnp.asarray, pools),
                             jnp.asarray(bt), jnp.asarray(lens))
    tcache = ttf.DecodeCache(tsc.from_numpy(pools), torch.from_numpy(bt),
                             torch.from_numpy(lens))
    leaves = tsc.flatten(tcache.layers)
    tol = LOGIT_TOL if dtype is not None else BF16_TOL
    for step in range(3):
        toks = rng.integers(1, cfg.vocab, (3, 1)).astype(np.int32)
        wl, jcache = jtf.decode_step(jp, jcfg, jcache, jnp.asarray(toks),
                                     page_size=P, attn_backend="ref")
        gl, tcache = ttf.decode_step(tp, cfg, tcache, torch.from_numpy(toks),
                                     P)
        np.testing.assert_allclose(_np(gl)[[0, 2]], np.asarray(wl)[[0, 2]],
                                   **tol, err_msg=f"step {step}")
        np.testing.assert_array_equal(tcache.seq_lens.numpy(),
                                      np.asarray(jcache.seq_lens))
    assert all(a is b for a, b in zip(tsc.flatten(tcache.layers), leaves))
    for name in pools:
        for kind in pools[name]:
            got = _np(tcache.layers[name][kind])
            want = np.asarray(jcache.layers[name][kind], np.float32)
            live = slice(1, None) if kind in ttf.KV_LEAVES else [0, 2]
            np.testing.assert_allclose(got[:, live], want[:, live], **tol,
                                       err_msg=f"{name}/{kind}")


def test_transformer_module_runs_the_functions():
    cfg = get_smoke_config("gemma2_27b")
    _, npt = reference_params("gemma2_27b")
    tp = tsc.from_numpy(npt)
    model = ttf.Transformer(cfg, tp)
    assert set(model.state_dict()) == {
        k.replace("/", ".") for k in _flat(tp, "params_tree")}
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab, (1, 16)).astype(np.int32))
    assert torch.equal(model(toks), ttf.forward(tp, cfg, toks))
