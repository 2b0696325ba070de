"""A cell at the port's smoke sizes on the CPU, for the tests."""
from __future__ import annotations

import dataclasses

from bench import harness

MIX = {"slots": 4, "max_seq": 256, "page_size": 64,
       "prompt": {"dist": "lognormal", "median": 48, "sigma": 0.5,
                  "min": 16, "max": 128},
       "new_tokens": {"dist": "uniform", "min": 6, "max": 16},
       "deck": 16, "check_requests": 6}
#: the mean gap a smoke cell may read.  The program computes in f32 from
#: the drawn bf16 weights, its KV pages in f32 too, so sound runs read
#: below 0.001; the float8 control and the planted faults read 0.04 and
#: more at these sizes
LIMIT = 0.03


def arch(name: str) -> dict:
    """The port's smoke config with the layer period of the benchmark's
    file for ``name``."""
    from repro_torch.configs import get_smoke_config
    out = dataclasses.asdict(get_smoke_config(name))
    out["pattern"] = harness.config_file(name)["arch"]["pattern"]
    return out


def cell(name: str) -> harness.Cell:
    config = {"arch": arch(name)}
    return harness.Cell(f"smoke-{name}", config, dict(MIX),
                        {"mean_gap": {"limit": LIMIT}}, 1, [], [],
                        harness.reference_module(config))


def f32_engine(c, params, device):
    """The engine over f32 copies of the weights (bf16 widens exactly:
    the reference reads the same values), its KV pages in f32: at these
    widths a bf16 page flips near-tied routes, and a flipped route moves
    a token's logits by up to ~2."""
    from repro_torch.models import schema
    eng = harness.build_engine(
        c, schema.map_tree(lambda t: t.float(), params), device)
    eng.pools = {name: {kind: t.float() for kind, t in leaves.items()}
                 for name, leaves in eng.pools.items()}
    return eng


def run(c: harness.Cell, seed: int, seconds: float = 3.0):
    """(run, weights) of ``seconds`` of the closed loop on the CPU."""
    loop, params = harness.set_up(c, seed, device="cpu",
                                  engine_factory=f32_engine)
    return harness.measure(loop, c, seconds, False), params
