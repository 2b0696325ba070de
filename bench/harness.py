"""One run of one cell: set-up, the measured window, the traced tail, the
correctness check.

The entry the window drives is ``repro_torch.serving.engine.
ServingEngine``: every client submits a request, ``step()`` runs in a
loop (greedy), and a client whose request finished submits its next one
as soon as the ``step()`` that delivered its last token returns.  A
client sees tokens only when ``step()`` returns.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names
its configuration and traffic, ``configs/<config>.json`` holds the
model, ``reference/<module>.py`` its plain reference (the module the
configuration names under ``"reference"``, ``model`` where it names
none), ``traffic/<traffic>.json`` the mix, ``limits/<cell>.json`` the
correctness limits, and ``metrics/<metric>.py`` reads each per-layer
metric from the run's ``Run`` record.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import time
import types
from pathlib import Path

import torch

from . import check, devtrace, stats, traffic, weights

HERE = Path(__file__).resolve().parent
TRACE_SECONDS = 5.0           # the traced tail after the window
#: what every reference module exports (bench/reference/__init__.py)
REFERENCE_EXPORTS = ("layout", "logits_at", "layer_kinds", "n_periods")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list
    reference: types.ModuleType       # the configuration's plain reference


def config_file(name: str, root: Path = HERE.parent) -> dict:
    """``root/bench/configs/<name>.json``."""
    return json.loads((root / "bench" / "configs" / f"{name}.json")
                      .read_text())


def load_cell(name: str, root: Path = HERE.parent) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, its files read
    from ``root/bench``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w, here = cells[name], root / "bench"
    config = config_file(w["config"], root)
    limits = json.loads((here / "limits" / f"{name}.json").read_text())

    def reports(m):
        return name in m.get("workloads", [name])
    return Cell(name, config, traffic.load(w["traffic"], here), limits,
                w["chips"], [m for m in bench["end_to_end"] if reports(m)],
                [m for m in bench["per_layer"] if reports(m)],
                reference_module(config, here))


def _load(path: Path, name: str) -> types.ModuleType:
    """The module of the file ``path``, executed anew under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = HERE):
    """``read(run)`` of ``root/metrics/<name>.py``."""
    return _load(root / "metrics" / f"{name}.py",
                 "bench_metric_" + name.replace(".", "_")).read


def reference_module(config: dict, root: Path = HERE) -> types.ModuleType:
    """The plain reference of the configuration ``config``: the module
    ``root/reference/<module>.py`` that its ``"reference"`` names,
    ``model`` where it names none."""
    name = config.get("reference", "model")
    path = root / "reference" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"configuration {config.get('name')!r} names the reference "
            f"{name!r}, and {path} is missing")
    mod = _load(path, "bench_reference_" + name.replace(".", "_"))
    missing = [f for f in REFERENCE_EXPORTS
               if not callable(getattr(mod, f, None))]
    if missing:
        raise AttributeError(f"{path} does not export {missing}")
    return mod


@dataclasses.dataclass
class Step:
    """One ``step()``: when it returned, each prompt it prefilled (length,
    the engine's seconds), and its decode: rows decoded, the positions
    those rows attended to in all (each its own included), the engine's
    seconds."""
    t: float
    prefills: list
    decoded: int
    keys: int
    decode_s: float | None


@dataclasses.dataclass
class Run:
    """What a run measured; the per-layer readers take it, and count
    with ``ref``, the plain reference of its configuration."""
    arch: dict
    slots: int
    t0: float
    t1: float
    records: list
    steps: list                       # the window's steps
    trace: devtrace.Trace | None = None
    trace_steps: list = dataclasses.field(default_factory=list)
    ref: types.ModuleType | None = None


class Loop:
    """The closed loop: ``mix.slots`` clients, each with one request in
    flight, over one engine."""

    def __init__(self, engine, mix: traffic.Traffic):
        self.engine, self.mix = engine, mix
        self.next_k = 0
        self.inflight: dict[int, stats.Record] = {}   # rid -> record
        self.records: list[stats.Record] = []

    def submit(self):
        prompt, n = self.mix.request(self.next_k)
        rec = stats.Record(self.next_k, len(prompt), n, time.perf_counter(),
                           prompt=prompt)
        self.inflight[self.engine.submit(prompt, n)] = rec
        self.records.append(rec)
        self.next_k += 1

    def step(self) -> Step:
        eng = self.engine
        n_dec = len(eng.decode_s)
        eng.step()
        t = time.perf_counter()
        prefills, decoded, keys, done = [], 0, 0, 0
        for rid, rec in list(self.inflight.items()):
            r = eng._requests[rid]
            n = len(r.out_tokens)
            if n > rec.seen:
                if not rec.deliveries:
                    prefills.append((rec.prompt_len, eng.prefill_s[rid]))
                rec.deliveries.append((t, n - rec.seen))
                rec.seen = n
                decoded += 1
                keys += r.seq_len
            if r.done:
                rec.done_t, rec.tokens = t, list(r.out_tokens)
                del self.inflight[rid]
                done += 1
        for _ in range(done):
            self.submit()
        dec = eng.decode_s[n_dec:]
        return Step(t, prefills, decoded, keys, dec[0] if dec else None)

    def run_until(self, t_end: float, steps: list):
        while True:
            steps.append(self.step())
            if steps[-1].t >= t_end:
                return


def build_engine(cell: Cell, params, device):
    from repro_torch.models.config import ArchConfig
    from repro_torch.serving.engine import ServingEngine
    t = cell.traffic
    return ServingEngine(ArchConfig(**cell.config["arch"]), params=params,
                         batch_size=t["slots"], max_seq=t["max_seq"],
                         page_size=t["page_size"], device=device)


def set_up(cell: Cell, seed: int, device="cuda", engine_factory=None):
    """Weights, the engine, every prefill length the deck holds and the
    decode batch warmed once, then every slot filled by its client's
    first request.  ``engine_factory(cell, weights, device)`` builds the
    engine (``build_engine`` unless a test substitutes one).  Returns
    (loop, weights)."""
    arch = cell.config["arch"]
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build
        build.build(["fused_read", "row_scatter", "paged_attention"])
    params = weights.draw(cell.reference.layout(arch), seed, device)
    engine = (engine_factory or build_engine)(cell, params, device)
    mix = traffic.Traffic(cell.traffic, seed, arch["vocab"])
    for length in mix.buckets():
        engine.submit(mix.warm_prompt(length), 2)
    while any(not r.done for r in engine._requests.values()):
        engine.step()
    loop = Loop(engine, mix)
    for _ in range(mix.slots):
        loop.submit()
    loop.step()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return loop, params


def measure(loop: Loop, cell: Cell, seconds: float, trace: bool) -> Run:
    """``seconds`` of the closed loop, then with ``trace`` the traced
    tail."""
    steps = []
    t0 = time.perf_counter()
    loop.run_until(t0 + seconds, steps)
    run = Run(cell.config["arch"], loop.mix.slots, t0, steps[-1].t,
              loop.records, steps, ref=cell.reference)
    if trace:
        run.trace, run.trace_steps = devtrace.trace_tail(
            loop, loop.engine, TRACE_SECONDS)
    return run


def end_to_end(run: Run, setup_s: float) -> dict:
    w = stats.window(run.records, run.t0, run.t1)
    out = {"tokens_per_s": (w.prompt_tokens + w.generated)
           / (run.t1 - run.t0), "setup_s": setup_s}
    if w.ttft_s:
        out["ttft_p95_ms"] = stats.percentile(w.ttft_s, 95) * 1e3
    if w.itl_s:
        out["itl_p95_ms"] = stats.percentile(w.itl_s, 95) * 1e3
    return out


def expected_tokens(prompt_len: int, max_new: int, max_seq: int) -> int:
    """How many tokens the engine serves a request: one from prefill,
    then one a decode step until ``max_new`` or the sequence limit."""
    n, seq = 1, prompt_len
    while True:
        n, seq = n + 1, seq + 1
        if n >= max_new or seq >= max_seq - 1:
            return n


def judge(cell: Cell, run: Run, params, seed: int):
    """(correct, checks, sampled requests, their gaps) of the window's
    finished requests: a sample drawn from the seed goes through the
    reference, and the mean of its served tokens' gaps is compared;
    every finished one must have the number of tokens the engine owes
    it, each inside the vocabulary; where the cell's limits name it, the
    share of served tokens that are not the reference's best is compared
    too."""
    w = stats.window(run.records, run.t0, run.t1)
    vocab, max_seq = cell.config["arch"]["vocab"], cell.traffic["max_seq"]
    failed = sum(
        len(r.tokens) != expected_tokens(r.prompt_len, r.max_new, max_seq)
        or not all(0 <= t < vocab for t in r.tokens) for r in w.finished)
    sample = check.sample(w.finished, cell.traffic["check_requests"], seed)
    gaps = check.served_gaps(cell.reference, params, cell.config["arch"],
                             sample)
    n = sum(len(g) for g in gaps)
    mean = sum(float(g.sum()) for g in gaps) / n if n else None
    off_top = sum(int((g > 0).sum()) for g in gaps) / n if n else None
    ok, checks = check.verdict(cell.limits, mean, failed, len(sample),
                               off_top)
    return ok, checks, sample, gaps
