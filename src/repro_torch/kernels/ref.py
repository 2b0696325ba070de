"""Plain PyTorch versions of the hand-written kernels (port of the
oracles in ``repro.kernels.ref``: the KSU floor search, plain and over
packed node images, the RSU leaf merge, the fused reads, the delta-sync
row scatter, the legacy layout's multi-field scatter, the log-replay
scatter and paged decode attention), and the routed expert FFN over rows
sorted by expert (``ragged_dot``, ``routed_ffn``: the training MoE's
ragged products in ``models/moe.py`` and the plain version of
``moe_grouped.py``).

The kernel wrappers (``key_search.py``, ``leaf_merge.py``,
``delta_scatter.py``, ``fused_read.py``) are held to these bit for bit,
``paged_attention.py`` within a tolerance (its sums run in another
order), and ``ops.py`` runs them for tensors on the CPU.
``paged_attention_split_ref`` mirrors the kernel's split into spans and
its combining pass, ``flat_scatter_mirror`` the scatters' flattened row
copy, ``key_search_image_mirror`` and ``key_search_block_mirror`` the
floor search's staged burst, chunks and passes in either mode,
``leaf_merge_mirror`` the merge's O(T * L) placement, ``replay_pairs``
and ``replay_verdict`` the log replay's walk over the pairs and its range
check; the tests hold them to the plain versions, nothing on a main path
runs them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import read_path as _rp
from ..core.keys import torch_key_cmp


def key_search_ref(q: torch.Tensor, qlen: torch.Tensor, keys: torch.Tensor,
                   klens: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """KSU floor search: the largest index ``i`` with ``valid[b, i]`` and
    ``keys[b, i] <= q[b]``, else -1.  Lanes compare as unsigned words at
    the first lane that differs; where every lane is equal the candidate is
    <= the query when ``klens <= qlen`` (signed int32, as the Pallas
    kernel compares them).

    q [B, KW], keys [B, N, KW]: int32 bit views of u32 lanes; qlen [B],
    klens and valid [B, N]: int32.  Returns [B] int32."""
    zero = torch.zeros((), dtype=torch.int32, device=keys.device)
    lanes = torch_key_cmp(keys, zero, q[:, None, :], zero)    # lanes only
    leq = (lanes < 0) | ((lanes == 0) & (klens <= qlen[:, None]))
    ar = torch.arange(keys.shape[1], dtype=torch.int32, device=keys.device)
    return torch.where(leq & (valid != 0), ar, -1).amax(dim=1) \
        .to(torch.int32)


def key_search_image_ref(q: torch.Tensor, qlen: torch.Tensor,
                         img: torch.Tensor, *, keys_off: int, lens_off: int,
                         count_off: int, n_keys: int,
                         key_words: int) -> torch.Tensor:
    """Floor search over packed node images: each request's candidate
    block (``n_keys`` keys of ``key_words`` lanes, their lengths and the
    live count, all int32 words, the count signed) is decoded from its
    [IW] image row at the static word offsets, then ``key_search_ref``."""
    B = img.shape[0]
    keys = img[:, keys_off:keys_off + n_keys * key_words] \
        .reshape(B, n_keys, key_words)
    klens = img[:, lens_off:lens_off + n_keys]
    count = img[:, count_off]
    ar = torch.arange(n_keys, dtype=torch.int32, device=img.device)
    valid = (ar[None, :] < count[:, None]).to(torch.int32)
    return key_search_ref(q, qlen, keys, klens, valid)


#: sources of the floor search's staged words (``image_stage_words``,
#: ``block_stage_words``)
STAGE_COUNT, STAGE_QLEN, STAGE_QUERY, STAGE_KEY, STAGE_LEN, STAGE_VALID = \
    range(6)


def image_stage_words(plan):
    """The burst of the image-mode floor search (``csrc/key_search.cu``)
    under a ``key_search.ImagePlan``, one warp's share: per chunk, the
    ``(lane, src, idx, dst)`` int64 tensors of every word it copies.
    ``src`` is one of the ``STAGE_*`` sources (the count word, the query
    length, query lane ``idx``, key word ``idx`` of the block, length
    ``idx``) and ``dst`` its word in the warp's buffer: count, query
    length, query lanes, then candidate i of the chunk at ``2 + KW + i *
    stride``, its lanes then its length.  Lane l copies the l-th, (l +
    32)-th, ... word of each of the kernel's loops."""
    KW, ST = plan.key_words, plan.stride
    out = []
    for c in range(plan.chunks):
        i0 = c * plan.chunk
        n = min(plan.chunk, plan.n_keys - i0)
        w, i = torch.arange(n * KW), torch.arange(n)
        parts = [(w % 32, torch.full_like(w, STAGE_KEY), i0 * KW + w,
                  2 + KW + w // KW * ST + w % KW),
                 (i % 32, torch.full_like(i, STAGE_LEN), i0 + i,
                  2 + KW + i * ST + KW)]
        if c == 0:
            h = torch.arange(2 + KW)
            src = torch.where(h < 2, h, STAGE_QUERY)
            parts.insert(0, (h % 32, src, (h - 2).clamp(min=0), h))
        out.append(tuple(torch.cat(x) for x in zip(*parts)))
    return out


def key_search_image_mirror(q: torch.Tensor, qlen: torch.Tensor,
                            img: torch.Tensor, plan, *, keys_off: int,
                            lens_off: int, count_off: int) -> torch.Tensor:
    """The image-mode floor search as its kernel performs it, on the CPU:
    each chunk's words copied into a buffer per request as
    ``image_stage_words`` assigns them (the buffer starts all ones, so a
    word the burst missed shows), then every candidate of the chunk
    compared from the buffer and masked with ``i < count``, the largest
    index kept across chunks.  Returns [B] int32, as
    ``key_search_image_ref``."""
    B, KW, ST = img.shape[0], plan.key_words, plan.stride
    buf = torch.full((B, plan.warp_words), -1, dtype=torch.int32)
    best = torch.full((B,), -1, dtype=torch.int32)
    for c, (_, src, idx, dst) in enumerate(image_stage_words(plan)):
        col = torch.where(src == STAGE_COUNT, count_off,
                          torch.where(src == STAGE_KEY, keys_off + idx,
                                      lens_off + idx))
        from_img = img[:, col.clamp(max=img.shape[1] - 1)]
        from_q = q[:, idx.clamp(max=KW - 1)]
        val = torch.where(src == STAGE_QLEN, qlen[:, None],
                          torch.where(src == STAGE_QUERY, from_q, from_img))
        buf[:, dst] = val
        i0 = c * plan.chunk
        n = min(plan.chunk, plan.n_keys - i0)
        cand = buf[:, 2 + KW:2 + KW + n * ST].reshape(B, n, ST)
        live = (torch.arange(i0, i0 + n)[None, :] < buf[:, :1]) \
            .to(torch.int32)
        got = key_search_ref(buf[:, 2:2 + KW], buf[:, 1],
                             cand[:, :, :KW].contiguous(), cand[:, :, KW],
                             live)
        best = torch.where(got >= 0, got + i0, best)
    return best


def block_stage_words(plan):
    """The bursts of the block-mode floor search (``csrc/key_search.cu``)
    under a ``key_search.BlockPlan``, one warp's share: per chunk, per
    pass of lanes (the highest lanes first), the ``(lane, src, idx, dst)``
    int64 tensors of every word it copies.  ``src`` is one of the
    ``STAGE_*`` sources: the query length, query lane ``idx``, key word
    ``idx`` of the request's [N, KW] block, length or valid word ``idx``;
    ``dst`` its word in the warp's buffer: the pass's query lanes from 0,
    the length at ``span``, candidate i of the chunk at ``head + i *
    stride``, its lanes of the pass, then its length and valid word at
    ``span`` and ``span + 1`` (copied in the chunk's first pass only).
    Lane l issues the l-th, (l + 32)-th, ... copy of each of the kernel's
    loops."""
    KW, SP, ST, H = plan.key_words, plan.span, plan.stride, plan.head
    out = []
    for c in range(plan.chunks):
        i0 = c * plan.chunk
        n = min(plan.chunk, plan.n_keys - i0)
        passes = []
        for w0 in range((KW - 1) // SP * SP, -1, -SP):
            ws = min(SP, KW - w0)
            w = torch.arange(ws + 1)
            parts = [(w % 32, torch.where(w < ws, STAGE_QUERY, STAGE_QLEN),
                      torch.where(w < ws, w0 + w, 0),
                      torch.where(w < ws, w, SP))]
            k = torch.arange(n * ws)            # word k of the pass's copies
            i, p = k // ws, k % ws
            parts.append((k % 32, torch.full_like(k, STAGE_KEY),
                          (i0 + i) * KW + w0 + p, H + i * ST + p))
            if w0 + SP >= KW:
                j = torch.arange(n)
                for src, off in ((STAGE_LEN, SP), (STAGE_VALID, SP + 1)):
                    parts.append((j % 32, torch.full_like(j, src), i0 + j,
                                  H + j * ST + off))
            passes.append(tuple(torch.cat(x) for x in zip(*parts)))
        out.append(passes)
    return out


def key_search_block_mirror(q: torch.Tensor, qlen: torch.Tensor,
                            keys: torch.Tensor, klens: torch.Tensor,
                            valid: torch.Tensor, plan) -> torch.Tensor:
    """The block-mode floor search as its kernel performs it, on the CPU:
    each pass's words copied into a buffer per request as
    ``block_stage_words`` assigns them (the buffer starts all ones, so a
    word the burst missed shows), then every candidate of the chunk
    compared from the buffer, lane by lane from the pass's highest, with
    no early exit: its verdict starts at ``klen <= qlen`` in a chunk's
    first pass and carries into the next; after the last pass it is
    masked with ``valid != 0`` and the largest index kept.  Returns [B]
    int32, as ``key_search_ref``."""
    B, KW, SP, H, ST = keys.shape[0], plan.key_words, plan.span, \
        plan.head, plan.stride
    flat = keys.reshape(B, -1)
    best = torch.full((B,), -1, dtype=torch.int32)
    for c, passes in enumerate(block_stage_words(plan)):
        i0 = c * plan.chunk
        n = min(plan.chunk, plan.n_keys - i0)
        carry = None
        for w0, (_, src, idx, dst) in zip(
                range((KW - 1) // SP * SP, -1, -SP), passes):
            ws = min(SP, KW - w0)
            buf = torch.full((B, plan.warp_words), -1, dtype=torch.int32) \
                if w0 + SP >= KW else buf
            pick = {STAGE_QLEN: qlen[:, None].expand(B, idx.numel()),
                    STAGE_QUERY: q[:, idx.clamp(max=KW - 1)],
                    STAGE_KEY: flat[:, idx.clamp(max=flat.shape[1] - 1)],
                    STAGE_LEN: klens[:, idx.clamp(max=plan.n_keys - 1)],
                    STAGE_VALID: valid[:, idx.clamp(max=plan.n_keys - 1)]}
            val = torch.zeros(B, idx.numel(), dtype=torch.int32)
            for s_, v in pick.items():
                val = torch.where(src == s_, v, val)
            buf[:, dst] = val
            cand = buf[:, H:H + n * ST].reshape(B, n, ST)
            k = cand[:, :, :ws].long() & 0xFFFFFFFF     # lanes as unsigned
            qs = buf[:, None, :ws].long() & 0xFFFFFFFF
            leq = cand[:, :, SP] <= buf[:, SP:SP + 1] if carry is None \
                else carry
            for w in range(ws - 1, -1, -1):     # the lowest difference wins
                leq = torch.where(k[..., w] != qs[..., w],
                                  k[..., w] < qs[..., w], leq)
            carry = leq
        ok = cand[:, :, SP + 1] != 0
        ar = torch.arange(i0, i0 + n, dtype=torch.int32)
        got = torch.where(leq & ok, ar, -1).amax(dim=1).to(torch.int32)
        best = torch.maximum(best, got)
    return best


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values to int32 as a 32-bit register holds their low bits."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def leaf_merge_mirror(nitems: torch.Tensor, nlog: torch.Tensor,
                      backptr: torch.Tensor, hints: torch.Tensor, *,
                      node_cap: int, log_cap: int):
    """The leaf merge as ``csrc/leaf_merge.cu`` computes it, on the CPU:
    the read path's shift register, the ranks in 32-bit unsigned
    arithmetic, then the O(T * L) placement in place of a sort.
    Sorted slot i goes to ``i + #{l : rank_l < rank_i}``; log slot l to
    its closed-form sorted term (0 below L, N at INT32_MAX, else
    ``min(live sorted, (rank_l - L) // (L + 1) + 1)``) plus
    ``#{m : rank_m < rank_l, or rank_m == rank_l and m < l}``.  Returns
    (perm, valid) as ``leaf_merge_ref``."""
    N, L = node_cap, log_cap
    B = nitems.shape[0]
    IMAX = 2 ** 31 - 1
    nl = nlog.long()[:, None]
    lanes = torch.arange(L)[None, :]
    pos = _rp.log_sort_positions(hints, nlog, L).long()
    rank = torch.where(lanes < nl, _wrap32(backptr.long() * (L + 1) + pos),
                       IMAX).long()             # [B, L]
    nv = nitems.long().clamp(0, N)[:, None]
    i = torch.arange(N)[None, :]
    srank = torch.where(i < nv, i * (L + 1) + L, IMAX)          # [B, N]
    out_s = i + (rank[:, None, :] < srank[:, :, None]).sum(dim=2)
    before = torch.minimum(nv, (rank - L).div(L + 1, rounding_mode="floor")
                           + 1)
    before = torch.where(rank == IMAX, N, torch.where(rank < L, 0, before))
    m = torch.arange(L)
    ties = (rank[:, None, :] == rank[:, :, None]) & (m[None, :] < m[:, None])
    out_l = before + ((rank[:, None, :] < rank[:, :, None]) | ties).sum(dim=2)
    out = torch.cat([out_s, out_l], dim=1)
    slots = torch.arange(N + L, dtype=torch.int32).expand(B, -1)
    perm = torch.full((B, N + L), -1, dtype=torch.int32)
    perm.scatter_(1, out, slots)
    valid = torch.cat([i < nv, lanes < nl], dim=1).to(torch.int32)
    return perm, valid


def leaf_merge_ref(nitems: torch.Tensor, nlog: torch.Tensor,
                   backptr: torch.Tensor, hints: torch.Tensor, *,
                   node_cap: int, log_cap: int):
    """RSU merged-emission order of a batch of leaves, without key
    compares: the stable order of the read path's merge ranks
    (``core/read_path.leaf_ranks``: the log block's order-hint
    shift-register sort, then back-pointer ranks).

    nitems, nlog [B]; backptr, hints [B, L]: int32.  Returns (perm, valid)
    [B, N + L] int32: ``perm[b, p]`` is the slot (sorted block, then log
    block) emitted at position p, in all N + L positions (unused slots
    follow in slot order); ``valid`` marks the used slots."""
    rank, used = _rp.leaf_ranks(nitems, nlog, backptr, hints, node_cap,
                                log_cap)
    perm = torch.argsort(rank, dim=1, stable=True).to(torch.int32)
    return perm, used.to(torch.int32)


def check_rows(rows: torch.Tensor, n: int) -> None:
    """Raise IndexError unless every row lies in [-n, n) (negative rows
    wrap Python-style); the plain scatters and the row scatters' wrappers
    call it before they write anything, the log replay's wrapper after
    its kernel flagged a bad row and wrote nothing."""
    if rows.numel():
        lo, hi = torch.stack(torch.aminmax(rows)).tolist()
        if lo < -n or hi >= n:
            raise IndexError(f"rows must lie in [{-n}, {n}), got [{lo}, {hi}]")


def snapshot_delta_scatter_ref(dst: torch.Tensor, rows: torch.Tensor,
                               upd: torch.Tensor) -> torch.Tensor:
    """Delta-sync row scatter, in place: dst[rows[i]] = upd[i]; returns
    ``dst``.  Duplicate rows must carry identical data (the store pads
    deltas with repeats), so application order is immaterial."""
    check_rows(rows, dst.shape[0])
    dst[rows.long()] = upd
    return dst


def snapshot_image_scatter_ref(image: torch.Tensor, rows: torch.Tensor,
                               upd: torch.Tensor) -> torch.Tensor:
    """Packed node-image row scatter, in place: image[rows[i]] = upd[i] —
    one whole node image per dirty row (same duplicates contract)."""
    return snapshot_delta_scatter_ref(image, rows, upd)


def snapshot_multi_scatter_ref(dsts, rows: torch.Tensor, upd):
    """Legacy-layout delta scatter over every field, in place:
    dsts[f][rows[i]] = upd[f][i] for each field f; returns ``dsts`` as a
    tuple.  ``dsts[f]`` is [S, W_f], ``upd[f]`` is [D, W_f] (trailing dims
    flattened by the caller).  Rows are checked against S before any
    field is written; duplicate rows carry identical data."""
    dsts, upd = tuple(dsts), tuple(upd)
    if dsts:
        check_rows(rows, dsts[0].shape[0])
    idx = rows.long()
    for d, u in zip(dsts, upd):
        d[idx] = u
    return dsts


def flat_scatter_words(plan):
    """The assignment of the delta-sync row copy (``csrc/scatter_rows.cuh``)
    under a ``delta_scatter.ScatterPlan``: for every (block, chunk, k,
    thread) slot, the dirty row ``i`` (the block), the field ``f`` and the
    word ``j`` of that field it moves, and ``live``, whether the slot
    holds a word (its flattened word lies in the row).  Each is a [grid,
    chunks, k, threads] int64 (``live`` bool) tensor.  The field comes
    from the kernel's branch-free search of the prefix offsets, padded
    past the last field as in shared memory."""
    K, T = plan.k, plan.threads
    W = plan.offsets[-1]
    i, c, k, t = torch.meshgrid(
        torch.arange(plan.grid), torch.arange(plan.chunks),
        torch.arange(K), torch.arange(T), indexing="ij")
    w = c * K * T + k * T + t             # the word within the row
    live = w < W
    off = torch.full((33,), 2 ** 31 - 1, dtype=torch.int64)  # as s_off
    off[:len(plan.offsets)] = torch.tensor(plan.offsets)
    f = torch.zeros_like(w)
    for step in (16, 8, 4, 2, 1):
        f = torch.where(off[f + step] <= w, f + step, f)
    return i, f, w - off[f], live


def flat_scatter_mirror(dsts, rows: torch.Tensor, upd, plan):
    """The delta-sync row copy as its kernel performs it, on the CPU, in
    place: every slot of ``flat_scatter_words`` copies its word, except
    where its block's table marks the row skipped: a row outside [-S, S)
    (the kernel's last guard; the wrapper raises first) or a row equal,
    after wrapping, to its predecessor in ``rows`` (a repeat, whose data
    the first row of its run writes).  ``dsts`` [S, W_f] and ``upd``
    [D, W_f] of 4-byte elements, fields in ``plan.offsets`` order, a plan
    of D rows.  Returns ``dsts`` as a tuple."""
    dsts, upd = tuple(dsts), tuple(upd)
    S = dsts[0].shape[0]
    r = rows.long()
    r = torch.where(r < 0, r + S, r)
    r = torch.where((r >= 0) & (r < S), r, -1)
    prev = torch.cat([torch.full((1,), -2), r[:-1]])
    target = torch.where(r == prev, -1, r)
    i, f, j, live = flat_scatter_words(plan)
    tgt = target[i]
    write = live & (tgt >= 0)
    for fi, (d, u) in enumerate(zip(dsts, upd)):
        sel = write & (f == fi)
        wf = d.shape[1]
        d.view(torch.int32).view(-1)[tgt[sel] * wf + j[sel]] = \
            u.view(torch.int32).reshape(-1)[i[sel] * wf + j[sel]]
    return dsts


def check_slots(slots: torch.Tensor, log_cap: int) -> None:
    """Raise IndexError unless every log slot lies in [0, log_cap): a slot
    past the log would address a neighbouring field of the image row."""
    if slots.numel():
        lo, hi = torch.stack(torch.aminmax(slots)).tolist()
        if lo < 0 or hi >= log_cap:
            raise IndexError(
                f"log slots must lie in [0, {log_cap}), got [{lo}, {hi}]")


def replay_verdict(rows: torch.Tensor, slots: torch.Tensor, n: int,
                   log_cap: int) -> int:
    """The range verdict the log-replay kernel writes to its flag: bit 0
    when some row lies outside [-n, n), bit 1 when some slot lies outside
    [0, log_cap); 0 when ``check_rows`` and ``check_slots`` both pass."""
    bad_row = bool(((rows < -n) | (rows >= n)).any())
    bad_slot = bool(((slots < 0) | (slots >= log_cap)).any())
    return int(bad_row) | int(bad_slot) << 1


def replay_pairs(plan):
    """The pairs every block of the log replay (``csrc/log_replay.cu``)
    reads under a ``delta_scatter.ReplayPlan``, and whether each lies
    below D.  A ``held`` plan loads all D pairs into every thread's
    registers: [D] tensors.  Else the walk over the pairs: for every
    (chunk, k, thread) slot the pair index ``c * pair_chunk + k * threads
    + t``, each a [chunks, k, threads] tensor."""
    if plan.held:
        i = torch.arange(plan.D)
        return i, i < plan.D
    c, k, t = torch.meshgrid(torch.arange(plan.chunks),
                             torch.arange(plan.k),
                             torch.arange(plan.threads), indexing="ij")
    i = c * plan.pair_chunk + k * plan.threads + t
    return i, i < plan.D


def log_replay_scatter_ref(image: torch.Tensor, rows: torch.Tensor,
                           slots: torch.Tensor, entries: torch.Tensor, *,
                           offs) -> torch.Tensor:
    """Log-replay scatter, in place on an int32 image; returns ``image``.

    Entry ``i`` (a marshalled ``[log_entry_words]`` record,
    ``schema.pack_log_entries``) writes its key/value lanes, lengths, op
    code, backptr, hint and vdelta words into image row ``rows[i]`` at the
    static layout offsets in ``offs`` (a ``schema.LogReplayOffsets``), each
    per-slot field advanced by ``slots[i] * width``.  ``nlog`` of every
    touched row is SET to the highest ``slots + 1`` among this call's
    entries for that row (not maxed with the row's old count).  Padded
    duplicate entries repeat the same record, so order is immaterial."""
    S, IW = image.shape
    check_rows(rows, S)
    check_slots(slots, offs.log_cap)
    if rows.numel() == 0:
        return image
    kw, vw = offs.key_words, offs.val_words
    r = rows.long() % S               # negative rows wrap Python-style
    j = slots.long()
    flat = image.view(-1)
    base = r * IW

    def lanes(off, width):            # flat indices of a multi-word field
        ar = torch.arange(width, device=image.device)
        return (base[:, None] + off + j[:, None] * width
                + ar[None, :]).reshape(-1)

    flat[lanes(offs.log_keys, kw)] = entries[:, 0:kw].reshape(-1)
    flat[base + offs.log_keylen + j] = entries[:, kw]
    flat[lanes(offs.log_vals, vw)] = entries[:, kw + 1:kw + 1 + vw].reshape(-1)
    flat[base + offs.log_vallen + j] = entries[:, kw + 1 + vw]
    flat[base + offs.log_op + j] = entries[:, kw + vw + 2]
    flat[base + offs.log_backptr + j] = entries[:, kw + vw + 3]
    flat[base + offs.log_hint + j] = entries[:, kw + vw + 4]
    flat[base + offs.log_vdelta + j] = entries[:, kw + vw + 5]
    # per-row final count: entries sharing a row all carry that row's max
    # slots+1, so the duplicate-index write below is order-free
    same_row = r[:, None] == r[None, :]
    final = torch.where(same_row, (j + 1)[None, :], 0).amax(dim=1)
    image[r, offs.nlog] = final.to(image.dtype)
    return image


def batched_scan_fused_ref(snap, lo, lolen, hi, hilen, *, cfg,
                           lb_fraction: float = 0.0, touched=None,
                           loads=None):
    """Fused SCAN: the whole traversal — cache-tiered descend, leaf
    resolve, log merge, version resolution — over the snapshot's combined
    cache+heap view.  Returns (ScanResult, meters i32[3] =
    [vmem_hits, heap_gathers, lb_routed]).  ``touched`` ([S + C] int32)
    and ``loads`` ([B] int32), when given, receive what the kernel writes
    into them: 1 at each row of the combined view the walk reads, and
    each request's dependent row reads (``read_path.RowTrace``)."""
    view = _rp.fused_view(snap, cfg)
    trace = None
    if touched is not None or loads is not None:
        trace = _rp.RowTrace(snap.image.shape[0] + snap.cache_image.shape[0],
                             lo.shape[0], lo.device)
    leaf0, meters = _rp.descend_fused(snap, view, lo, lolen, cfg,
                                      lb_fraction=lb_fraction, trace=trace)
    res = _rp.scan_from_leaf(view, leaf0, lo, lolen, hi, hilen, cfg, trace)
    if touched is not None:
        touched[trace.touched != 0] = 1
    if loads is not None:
        loads.copy_(trace.loads)
    return res, meters


def batched_get_fused_ref(snap, key, klen, *, cfg, lb_fraction: float = 0.0,
                          touched=None, loads=None):
    """Fused GET: fused SCAN(K, K) + the shared equality post-pass.
    Returns (GetResult, meters i32[3]); ``touched`` and ``loads`` as for
    ``batched_scan_fused_ref``."""
    res, meters = batched_scan_fused_ref(snap, key, klen, key, klen,
                                         cfg=cfg, lb_fraction=lb_fraction,
                                         touched=touched, loads=loads)
    return _rp.get_from_scan(res, key, klen), meters


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        seq_lens: torch.Tensor, start_pos=None, *,
                        scale: float | None = None,
                        softcap: float = 0.0) -> torch.Tensor:
    """Decode attention over paged KV, gather then dense: sequence ``b``'s
    query heads attend (GQA: head ``h`` reads KV head ``h // (H // KVH)``)
    to the positions ``start_pos[b] <= pos < seq_lens[b]`` of the pages
    ``block_tables[b]`` names, in f32, with ``tanh`` soft-capping when
    ``softcap`` is set.  A sequence whose window is empty gets zeros, as
    the Pallas kernel gives (the reference's jnp oracle would give the mean
    of V over every position instead).

    q [B, H, D]; k_pages, v_pages [NP, P, KVH, D]; block_tables [B, PPS],
    seq_lens and start_pos [B] int32.  Returns [B, H, D] of q's type."""
    B, H, D = q.shape
    _, P, KVH, _ = k_pages.shape
    G = H // KVH
    PPS = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if start_pos is None:
        start_pos = torch.zeros_like(seq_lens)
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, PPS * P, KVH, D)
    v = v_pages[bt].reshape(B, PPS * P, KVH, D)
    qg = q.reshape(B, KVH, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(PPS * P, device=q.device)[None, :]
    mask = (pos < seq_lens[:, None]) & (pos >= start_pos[:, None])
    s = torch.where(mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    o = torch.where(mask.any(dim=1)[:, None, None, None], o, 0.0)
    return o.reshape(B, H, D).to(q.dtype)


def paged_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              seq_lens: torch.Tensor, start_pos=None, *,
                              span: int, scale: float | None = None,
                              softcap: float = 0.0) -> torch.Tensor:
    """``paged_attention_ref`` computed as the kernel splits it
    (``csrc/paged_attention.cu``): each span of ``span`` positions gives a
    partial state (m = the span's max score, or -1e30 when it holds no
    visible position; l = the sum of e^(s - m); acc = the sum of
    e^(s - m) v), and the spans that hold visible positions combine as
    ``out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30)``
    with M the largest m_s, so an empty window gives zeros.  Same
    arguments as ``paged_attention_ref``."""
    B, H, D = q.shape
    _, P, KVH, _ = k_pages.shape
    G = H // KVH
    PPS = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if start_pos is None:
        start_pos = torch.zeros_like(seq_lens)
    n_spans = -(-PPS * P // span)
    pad = n_spans * span - PPS * P
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, PPS * P, KVH, D).float()
    v = v_pages[bt].reshape(B, PPS * P, KVH, D).float()
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, KVH, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(n_spans * span, device=q.device)[None, :]
    hi = seq_lens.clamp(max=PPS * P)[:, None]
    mask = (pos < hi) & (pos >= start_pos.clamp(min=0)[:, None])
    mask = mask.reshape(B, 1, 1, n_spans, span)
    s = torch.where(mask, s.reshape(B, KVH, G, n_spans, span), -1e30)
    # per span: (m, l, acc)
    m = s.amax(dim=-1)                                   # [B, KVH, G, S]
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgnj,bnjkd->bkgnd", p,
                       v.reshape(B, n_spans, span, KVH, D))
    # combine over the spans that hold visible positions
    live = mask.any(dim=-1)                              # [B, 1, 1, S]
    M = torch.where(live, m, -1e30).amax(dim=-1, keepdim=True)
    w = torch.where(live, torch.exp(m - M), 0.0)
    o = (w[..., None] * acc).sum(dim=3) \
        / (w * l).sum(dim=-1).clamp(min=1e-30)[..., None]
    return o.reshape(B, H, D).to(q.dtype)


def ragged_dot(a, w, sizes):
    """[m, p] x [E, p, q], rows grouped by ``sizes`` -> [m, q]: group e's
    rows times w[e]; rows past the groups are zeros (as ragged_dot's)."""
    out = a.new_zeros(a.shape[0], w.shape[-1])
    lo = 0
    for e, n in enumerate(sizes):
        if n:
            out[lo:lo + n] = torch.matmul(a[lo:lo + n], w[e])
        lo += n
    return out


def routed_ffn(xs, w_gate, w_up, w_down, sizes):
    """The expert FFN over rows sorted by expert, group e through expert
    e: (h = silu(xs w_gate[e]) * (xs w_up[e]), y = h w_down[e]), each
    product rounded to the model type."""
    h = F.silu(ragged_dot(xs, w_gate, sizes)) * ragged_dot(xs, w_up, sizes)
    return h, ragged_dot(h, w_down, sizes)
