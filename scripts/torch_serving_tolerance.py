"""How far the port's served logits drift from a plain full forward in
bf16, on the CPU at the smoke configs: the rehearsal that sets the
tolerances of ``chip_smoke.py``'s MoE/SSM serving checks.

For each model, at its smoke widths, at the depth the smoke drives on
the card and at the full config's vocabulary (the checks take maxima
over a row of logits, so over as many as on the card; the port's own
bf16 initialiser, seeded), a
``ServingEngine`` serves seeded prompts, and per seed it prints what the
smoke checks, with the smoke's own functions: the largest gap between a
served token's logit and its row's maximum in a full forward over the
prompt and the tokens served before it, and how many served tokens are
that forward's argmax (``served_gap``); the largest difference between
the logits of prefill of ``prompt[:-k]`` plus k teacher-forced decode
steps and those of a full forward, with its own MoE routes and with
every route forced to the full forward's, and how many routes flipped
(``handoff_drift``).  The same in f32 shows what is the arithmetic's
and what bf16's.

With ``--encdec``, the same for path 7 (``chip_smoke.ENCDEC_TOL``):
pixtral-12b (40 layers) and seamless-m4t-medium (12 encoder and 12
decoder layers) at their smoke widths and full vocabularies, 8
sequences through ``launch/steps.py``'s ``prefill_step`` and
``decode_step`` with the smoke's own functions (``serve_encdec``,
``encdec_gap``, ``replay_encdec``, ``encdec_f32_drift``): the served
tokens' gap and argmax agreement, the decode steps through the plain
attention against the served run (on the CPU both are the plain
version), seamless's f32 drift; then the bounds by the rule of
``chip_smoke.MOE_SSM_TOL``.

    python scripts/torch_serving_tolerance.py [--seeds 6] [--encdec]
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (encdec_batch, encdec_f32_drift,  # noqa: E402
                        encdec_gap, handoff_drift, replay_encdec,
                        serve_encdec, served_gap)  # (adds src/)
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import schema as sc  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

# (arch, layers): the depths chip_smoke.py serves (jamba: one superblock)
ARCHS = (("olmoe-1b-7b", 16), ("mamba2-1.3b", 48), ("jamba-v0.1-52b", 8))
PAGE, MAX_SEQ, SLOTS, REQUESTS, NEW = 64, 512, 4, 8, 16
# path 7: (arch, decoder layers, encoder layers) at the card's depths; 8
# sequences of 128 prompt positions in pages of 16, decode pools of 256
# positions a sequence, 16 greedy tokens
ENCDEC = (("pixtral-12b", 40, 0), ("seamless-m4t-medium", 12, 12))
ENC_BATCH, ENC_PROMPT, ENC_PAGE, ENC_SEQ = 8, 128, 16, 256


def rehearse(cfg, params, seed: int) -> dict:
    """One seed's figures: served-token gap and argmax agreement, and the
    handoff's largest differences (own and forced routes) and flips over
    every prompt."""
    eng = ServingEngine(cfg, params, batch_size=SLOTS, max_seq=MAX_SEQ,
                        page_size=PAGE, device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(64, 257, REQUESTS)]
    rids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    outs = eng.run_until_done()
    gap, agree, n, _ = served_gap(eng.model, dict(zip(rids, prompts)),
                                  outs, "cpu")
    out = {"gap": gap, "agree": agree / n, "drift": 0.0, "forced": None,
           "flips": 0, "routes": 0}
    for p in prompts:
        h = handoff_drift(eng.model, p, PAGE, "cpu")
        out["drift"] = max(out["drift"], h["drift"])
        if h["forced"] is not None:
            out["forced"] = max(out["forced"] or 0.0, h["forced"])
        out["flips"] += h["flips"]
        out["routes"] += h["routes"]
    return out


def rehearse_encdec(cfg, seed: int) -> dict:
    """One seed's figures of path 7: served-token gap and agreement, the
    plain attention's decode logits against the served run's, and (with
    an encoder) the f32 drift of prefill + decode against the f32 full
    forward."""
    params = sc.init(tf.schema(cfg), torch.Generator().manual_seed(seed),
                     "cpu")
    model = tf.Transformer(cfg, params)
    batch = encdec_batch(cfg, ENC_BATCH, ENC_PROMPT, seed, "cpu")
    run = serve_encdec(model, batch, ENC_PAGE, ENC_SEQ, NEW, "cpu")
    gap, agree, n = encdec_gap(model, batch, run["served"], run["enc_out"])
    cache = run["cache"]
    plain = replay_encdec(model, cache._replace(
        seq_lens=cache.seq_lens - (NEW - 1)), run["served"], ENC_PAGE,
        run["enc_out"], attn=ref.paged_attention_ref)
    out = {"gap": gap, "agree": agree / n,
           "plain": float((plain - run["logits"]).abs().max()), "f32": None}
    if cfg.n_enc_layers:
        model32 = tf.Transformer(cfg, sc.map_tree(lambda t: t.float(),
                                                  params))
        out["f32"] = encdec_f32_drift(model32, batch, run["served"],
                                      ENC_PAGE, ENC_SEQ, "cpu")
    return out


def bound(x: float) -> float:
    """1.5 times the largest figure, rounded up to a multiple of 1/32."""
    return math.ceil(1.5 * x * 32) / 32


def main_encdec(seeds: int) -> None:
    for arch, layers, enc_layers in ENCDEC:
        cfg = dataclasses.replace(get_smoke_config(arch), n_layers=layers,
                                  n_enc_layers=enc_layers,
                                  vocab=get_config(arch).vocab)
        res = [rehearse_encdec(cfg, seed) for seed in range(seeds)]

        def col(key):
            return [None if r[key] is None else round(r[key], 6)
                    for r in res]
        gap = max(r["gap"] for r in res)
        agree = min(r["agree"] for r in res)
        print(f"{arch} smoke, {layers} + {enc_layers} layers, vocab "
              f"{cfg.vocab}, bf16 (seeds 0-{seeds - 1}; {ENC_BATCH} "
              f"sequences of {ENC_PROMPT} prompt positions, {NEW} tokens): "
              f"served-token gap {col('gap')}, argmax agreement "
              f"{col('agree')}, plain attention vs served run "
              f"{col('plain')}, f32 drift {col('f32')}; bounds: gap "
              f"{bound(gap)} (largest {gap:.4f}), agreement floor "
              f"{agree - 0.15:.4f} (lowest {agree:.4f})", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--encdec", action="store_true",
                    help="rehearse path 7 (pixtral, seamless) only")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    if args.encdec:
        main_encdec(args.seeds)
        return
    for arch, layers in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), n_layers=layers,
                                  vocab=get_config(arch).vocab)
        for name, dtype in (("bf16", None), ("f32", torch.float32)):
            res = []
            for seed in range(args.seeds):
                params = sc.init(tf.schema(cfg),
                                 torch.Generator().manual_seed(seed), "cpu")
                if dtype is not None:
                    params = sc.map_tree(lambda t: t.to(dtype), params)
                res.append(rehearse(cfg, params, seed))

            def col(key):
                return [None if r[key] is None else round(r[key], 4)
                        for r in res]
            print(f"{arch} smoke, {layers} layers, vocab {cfg.vocab}, {name} "
                  f"(seeds "
                  f"0-{args.seeds - 1}; {REQUESTS} requests of 64-256 "
                  f"prompt tokens, {NEW} new tokens, k = 8): served-token "
                  f"gap {col('gap')}, argmax agreement {col('agree')}; "
                  f"handoff difference {col('drift')}, with the routes "
                  f"forced {col('forced')}, route flips "
                  f"{[(r['flips'], r['routes']) for r in res]}", flush=True)


if __name__ == "__main__":
    main()
