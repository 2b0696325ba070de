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

    python scripts/torch_serving_tolerance.py [--seeds 6]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import handoff_drift, served_gap  # noqa: E402  (adds src/)
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import schema as sc  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

# (arch, layers): the depths chip_smoke.py serves (jamba: one superblock)
ARCHS = (("olmoe-1b-7b", 16), ("mamba2-1.3b", 48), ("jamba-v0.1-52b", 8))
PAGE, MAX_SEQ, SLOTS, REQUESTS, NEW = 64, 512, 4, 8, 16


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
    gap, agree, n = served_gap(eng.model, dict(zip(rids, prompts)), outs,
                               "cpu")
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
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
