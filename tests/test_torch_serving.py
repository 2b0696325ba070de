"""The port's serving path held to the JAX reference: the paged KV cache
whose page table is a Honeycomb store (pages, block tables, prefix-cache
answers, store meters) and the continuous-batching engine (tokens, stats,
pages in use) on the same requests and the reference's own parameters,
cast to f32 so that the greedy tokens of the two frameworks agree; then
the port's engine against its own naive generation, and the serving CLI
on the CPU.  Everything here runs the plain PyTorch path (device "cpu")."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: breaks an import cycle)
from repro.configs import get_smoke_config as jget_smoke
from repro.models import transformer as jtf
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.kv_cache import PagedKVCache as JCache
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import schema as tsc
from repro_torch.models import transformer as ttf
from repro_torch.serving import PagedKVCache, ServingEngine, page_key
from test_torch_models import reference_params


def _same_stores(a, b):
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
    assert dataclasses.asdict(a.sync_stats) == \
        dataclasses.asdict(b.sync_stats)


def test_paged_kv_cache_matches_reference():
    """Allocations, frees, block-table GET batches and prefix floor SCANs
    interleaved; every answer and both stores' meters equal."""
    ref, port = JCache(n_pages=64, page_size=4), \
        PagedKVCache(n_pages=64, page_size=4, device="cpu")
    rng = np.random.default_rng(0)
    for rnd in range(4):
        for s in range(6):
            for b in range(int(rng.integers(1, 5))):
                if port.table.get(page_key(s + 10 * rnd, b)) is None:
                    assert ref.allocate(s + 10 * rnd, b) == \
                        port.allocate(s + 10 * rnd, b)
        ids = [s + 10 * rnd for s in range(6)] + [999]
        np.testing.assert_array_equal(ref.lookup_block_tables(ids, 5),
                                      port.lookup_block_tables(ids, 5))
        for s in range(0, 6, 2):
            ref.free_seq(s + 10 * rnd, 5)
            port.free_seq(s + 10 * rnd, 5)
        assert ref.pages_in_use == port.pages_in_use
        assert ref.free_pages == port.free_pages
    toks = rng.integers(1, 100, (16,))
    for kv in (ref, port):
        kv.register_prefix(toks, seq_id=9)
    for probe in (toks, np.concatenate([toks[:8], [1, 2, 3, 4]]),
                  rng.integers(100, 200, (8,))):
        assert ref.longest_cached_prefix(probe) == \
            port.longest_cached_prefix(probe)
    assert port.longest_cached_prefix(toks[:12]) == (9, 12)
    _same_stores(ref.table, port.table)
    _same_stores(ref.prefix, port.prefix)
    items = port.table.scan(page_key(11, 0), page_key(11, 3))
    assert [k[:8] for k, _ in items] == [int(11).to_bytes(8, "big")] \
        * len(items) and items


def _serve(engine_cls, cfg, params, prompts, n_new, **kw):
    eng = engine_cls(cfg, params, **kw)
    rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    outs = eng.run_until_done()
    return eng, [outs[r] for r in rids]


@pytest.mark.parametrize("arch,n_req,plen,n_new,batch,max_seq", [
    ("qwen2p5_3b", 2, 13, 5, 2, 128),
    ("qwen2p5_3b", 5, 8, 4, 2, 64),        # oversubscribed: slots reused
    ("gemma2_27b", 3, 40, 6, 2, 128),      # decode past the window of 32
    ("gemma3_12b", 2, 13, 6, 2, 64),       # past gemma3's window of 16
    ("stablelm_3b", 2, 13, 5, 2, 128),
    ("olmoe_1b_7b", 3, 13, 5, 2, 128),
    ("mixtral_8x22b", 2, 40, 5, 2, 128),
    # mamba layers: prompts fill their pages (the reference's engine
    # carries a state over the pad tail, the port's stops at the prompt:
    # test_engine_state_stops_at_the_prompt), and each padded length is
    # one SSD chunk
    ("mamba2_1p3b", 2, 16, 6, 2, 128),
    ("mamba2_1p3b", 5, 32, 4, 2, 64),      # oversubscribed: rows reused
    ("jamba_v0p1_52b", 2, 16, 5, 2, 128),
    ("jamba_v0p1_52b", 5, 48, 4, 2, 128),  # oversubscribed
    # token prompts, as the reference's engine serves both: pixtral embeds
    # its tokens, seamless runs without an encoder output
    ("pixtral_12b", 3, 13, 5, 2, 128),
    ("seamless_m4t_medium", 3, 21, 5, 2, 128)])
def test_engine_matches_reference_engine(arch, n_req, plen, n_new, batch,
                                         max_seq):
    jp, npt = reference_params(arch)
    rng = np.random.default_rng(plen)
    prompts = [rng.integers(1, 256, (plen,)) for _ in range(n_req)]
    kw = dict(batch_size=batch, max_seq=max_seq, page_size=16)
    jeng, want = _serve(JEngine, jget_smoke(arch), jp, prompts, n_new, **kw)
    teng, got = _serve(ServingEngine, get_smoke_config(arch),
                       tsc.from_numpy(npt), prompts, n_new, device="cpu",
                       **kw)
    assert got == want
    assert all(len(t) == n_new for t in got)
    assert teng.stats == jeng.stats
    assert teng.kv.pages_in_use == jeng.kv.pages_in_use == 1
    _same_stores(jeng.kv.table, teng.kv.table)
    assert set(teng.prefill_s) == set(range(n_req))
    assert len(teng.decode_s) == teng.stats["decode_steps"]


@pytest.mark.parametrize("arch,n_req,plen", [("mamba2_1p3b", 3, 13),
                                             ("jamba_v0p1_52b", 3, 21)])
def test_engine_state_stops_at_the_prompt(arch, n_req, plen):
    """Prompts that do not fill their pages, 3 requests in 2 slots: every
    served token is the argmax of the reference's full forward over the
    prompt and the tokens served before it (greedy decoding), so the
    mamba states handed to decode are those after the prompt, not after
    its pad tail."""
    jp, npt = reference_params(arch)
    rng = np.random.default_rng(plen)
    prompts = [rng.integers(1, 256, (plen,)) for _ in range(n_req)]
    _, outs = _serve(ServingEngine, get_smoke_config(arch),
                     tsc.from_numpy(npt), prompts, 4, batch_size=2,
                     max_seq=64, page_size=16, device="cpu")
    for p, out in zip(prompts, outs):
        seq = np.concatenate([p, out[:-1]]).astype(np.int32)[None]
        logits = jtf.forward(jp, jget_smoke(arch), tokens=jnp.asarray(seq),
                             remat=False)
        assert out == np.asarray(logits)[0, plen - 1:].argmax(-1).tolist()


def naive_generate(params, cfg, prompt, n_new):
    toks = list(map(int, prompt))
    for _ in range(n_new):
        logits = ttf.forward(params, cfg, torch.tensor([toks]))
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def test_engine_matches_naive_generation():
    """The port's engine (bf16 parameters from its own initializer) gives
    the tokens of greedy decoding by full forwards."""
    cfg = get_smoke_config("qwen2p5_3b")
    params = tsc.init(ttf.schema(cfg), torch.Generator().manual_seed(0),
                      "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, (13,)) for _ in range(2)]
    _, outs = _serve(ServingEngine, cfg, params, prompts, 5, batch_size=2,
                     max_seq=128, page_size=16, device="cpu")
    for p, out in zip(prompts, outs):
        assert out == naive_generate(params, cfg, p, 5)


def test_engine_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(get_smoke_config("qwen2p5_3b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(n_pages=4, page_size=4)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-1.3b",
                                  "jamba-v0.1-52b"])
def test_serve_cli_serves_moe_and_ssm_archs_on_cpu(arch, capsys):
    outs = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3", "--new-tokens", "3"])
    assert len(outs) == 3 and all(len(t) == 3 for t in outs.values())
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out


def test_serve_cli_on_cpu(capsys):
    outs = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                       "--new-tokens", "4"])
    assert len(outs) == 3 and all(len(t) == 4 for t in outs.values())
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
