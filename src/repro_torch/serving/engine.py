"""Batched serving engine: continuous batching over the paged KV cache
(port of ``repro.serving.engine``).

The request path: slot admission (continuous batching) -> prefill into
allocated pages -> per decode step, block-table assembly via one batched
Honeycomb GET (the device read path: the fused GET kernel on CUDA) ->
decode step (paged attention: the hand-written kernel on CUDA) ->
in-order token delivery.  Page allocation and completion-time frees are
host-side Honeycomb writes — the paper's read/write split, transplanted.

Every active request owns a fixed batch *slot*: its attention state lives
in pages (slot-independent, indexed through the Honeycomb table), its
mamba layers' recurrent state and conv tail at the slot's row, which the
next request's prefill in that slot overwrites.  A model without
attention layers (mamba2) still allocates and looks up its pages, as
the reference's engine does.  Page 0 is reserved scratch: idle slots'
block tables point at it, so their (ignored) decode lanes never touch a
live page.

Requests are token prompts, as in the reference's engine: an
embedding-input model (pixtral) embeds its tokens, and an
encoder-decoder model (seamless) is served without an encoder output,
its ``xattn`` leaves unused.  Embeddings and encoder outputs go through
``launch/steps.py``'s ``prefill_step``/``decode_step``.

The model and KV pools live on ``device`` (``"cuda"`` unless the caller
passes ``"cpu"``, which runs every kernel's plain version).

With ``telemetry`` enabled (the default) every tick records its spans in
the process-wide ring ``core/telemetry.SPANS``, each child holding its
parent's id: ``engine.step`` over ``engine.admit``, ``engine.prefill``
(``page_table.put`` a page, ``model.prefill``, ``engine.kv_write``,
``engine.sync``) and ``engine.decode`` (``page_table.reserve``,
``page_table.lookup``, ``engine.h2d``, ``model.decode``, ``engine.sync``,
``page_table.free``), and per request ``request.queue``, from ``submit``
to the start of its prefill.  No span waits on the device: the only
waits are the program's own (``engine.sync``).  Disabled, it records
nothing; ``prefill_s``/``decode_s`` are the same spans' seconds either
way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import TelemetryConfig
from ..core.telemetry import CLOCK, SPANS, span, timed_span
from ..models import schema as sc
from ..models import transformer as tf
from ..models.config import ArchConfig
from .kv_cache import PagedKVCache

_now = CLOCK


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # int32 [S]
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    seq_len: int = 0
    slot: int = -1
    done: bool = False


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params=None, *, batch_size: int = 4,
                 max_seq: int = 256, page_size: int = 32, seed: int = 0,
                 device="cuda",
                 telemetry: TelemetryConfig = TelemetryConfig()):
        if max_seq % page_size:
            raise ValueError(f"max_seq {max_seq} is not a multiple of the "
                             f"page size {page_size}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the engine runs on the GPU; pass "
                "device='cpu' to run its plain PyTorch path")
        self.cfg = cfg
        self.page_size = page_size
        self.max_seq = max_seq
        self.batch_size = batch_size
        self.pps = max_seq // page_size
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = sc.init(tf.schema(cfg), gen, self.device)
        else:
            params = sc.map_tree(lambda t: t.to(self.device), params)
        self.model = tf.Transformer(cfg, params)
        # the span ring, or None with telemetry off
        self._spans = SPANS if telemetry.enabled else None
        n_pages = batch_size * self.pps + 1     # +1: reserved scratch page 0
        self.kv = PagedKVCache(n_pages, page_size, device=self.device,
                               spans=self._spans)
        self.kv.free_pages = list(range(n_pages - 1, 0, -1))  # reserve 0
        cache_tree = sc.stack(
            cfg.n_superblocks,
            tf.layer_cache_schema(cfg, batch_size, self.pps, page_size))
        # KV pool rows = physical pages: [n_superblocks, n_pages, P, KVH,
        # HD]; mamba states keep the schema's slot rows [n_superblocks,
        # batch, ...]
        self.pools = {
            name: {kind: torch.zeros(
                (d.shape[0], n_pages, *d.shape[2:]) if kind in tf.KV_LEAVES
                else d.shape, dtype=d.dtype, device=self.device)
                for kind, d in leaves.items()}
            for name, leaves in cache_tree.items()}
        self._slots: list[int | None] = [None] * batch_size
        self._requests: dict[int, Request] = {}
        self._next_rid = 0
        self._submit_t: dict[int, float] = {}
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens": 0}
        # the engine.prefill and engine.decode spans' seconds, each ending
        # in a device sync (the sampled token reaches the host): prefill
        # per request id, and each decode step with its block-table lookup
        self.prefill_s: dict[int, float] = {}
        self.decode_s: list[float] = []

    # ------------------------------------------------------------- intake
    def submit(self, prompt, max_new_tokens: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._requests[rid] = Request(rid, np.asarray(prompt, np.int32),
                                      max_new_tokens=max_new_tokens)
        self._submit_t[rid] = _now()
        return rid

    # ------------------------------------------------------------ prefill
    @torch.inference_mode()
    def _prefill_one(self, r: Request, slot: int):
        ring = self._spans
        S = len(r.prompt)
        with timed_span(ring, "engine.prefill", rid=r.rid, tokens=S) as sp:
            toks = np.pad(r.prompt, (0, -S % self.page_size))
            n_blocks = len(toks) // self.page_size
            pages = [self.kv.allocate(r.rid, b) for b in range(n_blocks)]
            with span(ring, "model.prefill"):
                # prefill's MoE through each token's top-k experts only;
                # decode_step stays dense (a decode batch touches nearly
                # every expert)
                logits, cache = self.model.prefill(
                    torch.from_numpy(toks[None]).to(self.device),
                    self.page_size, S - 1, moe_impl="grouped")
            with span(ring, "engine.kv_write"):
                idx = torch.tensor(pages, device=self.device)
                for name, pools in self.pools.items():
                    for kind, pool in pools.items():
                        new = cache.layers[name][kind]
                        if kind in tf.KV_LEAVES:  # -> the allocated pages
                            pool[:, idx] = new[:, :n_blocks].to(pool.dtype)
                        else:                     # mamba state -> slot row
                            pool[:, slot] = new[:, 0].to(pool.dtype)
            r.seq_len = S
            r.slot = slot
            self._slots[slot] = r.rid
            with span(ring, "engine.sync"):
                r.out_tokens.append(int(torch.argmax(logits[0])))
            self.stats["prefills"] += 1
            self.stats["tokens"] += 1
        self.prefill_s[r.rid] = sp.t1 - sp.t0
        submit_t = self._submit_t.pop(r.rid)
        if ring is not None:
            ring.add("request.queue", submit_t, sp.t0, rid=r.rid)

    # ------------------------------------------------------------- decode
    def _active(self) -> list[Request]:
        return [self._requests[rid] for rid in self._slots
                if rid is not None and not self._requests[rid].done]

    @torch.inference_mode()
    def _decode_batch(self):
        act = self._active()
        if not act:
            return
        ring = self._spans
        B, pps = self.batch_size, self.pps
        with timed_span(ring, "engine.decode", rows=len(act),
                        positions=sum(r.seq_len + 1 for r in act)) as sp:
            # a page for the next token (host-side Honeycomb GET and PUT)
            self.kv.reserve([(r.rid, r.seq_len // self.page_size)
                             for r in act])
            # block tables, lengths and tokens in ONE host array, so one
            # copy takes them to the device
            host = np.zeros(B * pps + 2 * B, np.int32)
            bt = host[:B * pps].reshape(B, pps)
            lens, toks = host[B * pps:B * pps + B], host[B * pps + B:]
            rows = self.kv.lookup_block_tables([r.rid for r in act], pps)
            for i, r in enumerate(act):
                bt[r.slot] = rows[i]
                lens[r.slot] = r.seq_len
                toks[r.slot] = r.out_tokens[-1]
            if bt.min() < 0 or bt.max() >= self.kv.n_pages:
                raise RuntimeError(f"block table names a page outside "
                                   f"[0, {self.kv.n_pages})")
            with span(ring, "engine.h2d"):
                dev = torch.from_numpy(host).to(self.device, copy=True)
            with span(ring, "model.decode"):
                cache = tf.DecodeCache(
                    layers=self.pools, block_tables=dev[:B * pps].view(B, pps),
                    seq_lens=dev[B * pps:B * pps + B])
                logits, _ = self.model.decode_step(
                    cache, dev[B * pps + B:].view(B, 1), self.page_size)
            with span(ring, "engine.sync"):
                out = torch.argmax(logits, dim=-1).cpu().numpy()
            for r in act:
                r.seq_len += 1
                r.out_tokens.append(int(out[r.slot]))
                self.stats["tokens"] += 1
                if len(r.out_tokens) >= r.max_new_tokens \
                        or r.seq_len >= self.max_seq - 1:
                    r.done = True
                    self._slots[r.slot] = None
                    self.kv.free_seq(r.rid, -(-(r.seq_len + 1)
                                              // self.page_size))
            self.stats["decode_steps"] += 1
        self.decode_s.append(sp.t1 - sp.t0)

    # ----------------------------------------------------------------- run
    def step(self):
        """One scheduler tick: admit into free slots, then decode."""
        with span(self._spans, "engine.step"):
            with span(self._spans, "engine.admit") as sp:
                waiting = [r for r in self._requests.values()
                           if r.slot < 0 and not r.done]
                free = [i for i, rid in enumerate(self._slots)
                        if rid is None]
                admitted = list(zip(waiting, free))
                sp.tag(waiting=len(waiting), admitted=len(admitted))
            for r, slot in admitted:
                self._prefill_one(r, slot)
            self._decode_batch()

    def run_until_done(self, max_ticks: int = 1000):
        for _ in range(max_ticks):
            if all(r.done for r in self._requests.values()):
                break
            self.step()
        return {rid: r.out_tokens for rid, r in self._requests.items()}
