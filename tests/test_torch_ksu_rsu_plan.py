"""The plans of the block-mode floor search and the leaf merge, and their
CPU mirrors, held to the plain versions and to the JAX reference.
``key_search.block_plan`` sizes the shared-memory buffer into which a
warp of ``csrc/key_search.cu`` stages one request's query and candidates;
``ref.block_stage_words`` walks its copies and
``ref.key_search_block_mirror`` searches through them, chunk by chunk and
pass by pass.  ``leaf_merge.merge_plan`` picks the merge's instance and
``ref.leaf_merge_mirror`` places every slot by the kernel's O(T * L)
count and closed form.  The mirrors must equal ``key_search_ref`` /
``leaf_merge_ref`` and the reference's ``ref`` and ``interpret``
backends, tolerance 0 (integers).  The inputs come from
``tests/test_torch_cuda.py``'s case builders, which the card's tests
share; the wild ones span the whole int32 range."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: breaks an import cycle)
import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import key_search, leaf_merge, ref
from test_torch_cuda import (BLOCK_SEARCH, MERGE_SWEEP, _block_case,
                             _merge_case, _search_case, _wild_merge_case)

SMEM_LIMIT = 48 * 1024          # a block's shared memory without opt-in


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


# ---- block-mode floor search ---------------------------------------------

@pytest.mark.parametrize("key_words", [1, 2, 3, 4, 5, 8, 12, 16, 677, 1020,
                                       1021, 1022, 1024, 5000])
@pytest.mark.parametrize("n_keys", [1, 3, 64, 300, 100_000])
def test_block_plan_routes_and_budgets(key_words, n_keys):
    """An odd stride of words, room for the lanes, length and valid word;
    the whole key a pass where one candidate fits beside the query, else
    at most 32 candidates a chunk; every buffer within the warp's words
    and the block under 48 KB; every key width the wrapper takes is
    planned."""
    p = key_search.block_plan(n_keys, key_words)
    assert p.stride % 2 == 1
    assert p.stride >= p.span + 2 and p.head == p.span + 1
    assert 1 <= p.span <= key_words
    assert p.spans * p.span >= key_words > (p.spans - 1) * p.span
    assert 1 <= p.chunk <= n_keys
    assert p.chunks * p.chunk >= n_keys > (p.chunks - 1) * p.chunk
    if p.span < key_words:
        assert p.chunk <= 32
    assert p.head + p.chunk * p.stride == p.warp_words \
        <= key_search.BLOCK_WARP_WORDS
    assert 1 <= p.warps <= 4
    assert p.smem_bytes == 4 * p.warps * p.warp_words <= SMEM_LIMIT


def test_block_plan_at_the_stores_blocks():
    """The default geometry's sorted block (64 keys of 8 lanes) takes one
    chunk and one pass at a stride of 11 words (713 words a warp)."""
    p = key_search.block_plan(64, 8)
    assert (p.chunk, p.chunks, p.span, p.spans, p.head, p.stride,
            p.warp_words) == (64, 1, 8, 1, 9, 11, 713)
    assert key_search.block_plan(300, 8).chunks == 2
    wide = key_search.block_plan(40, 5000)
    assert (wide.chunk, wide.chunks, wide.span, wide.spans) \
        == (32, 2, 59, 85)


@pytest.mark.parametrize("n_keys,key_words", [
    (64, 8), (64, 4), (300, 8), (80, 12), (300, 3), (3, 1), (40, 3),
    (7, 1022), (40, 1500), (33, 1500)])
def test_block_plan_stages_every_word_once(n_keys, key_words):
    """Over each chunk's passes the burst copies every key word of the
    chunk once and each candidate's length and valid word once; each pass
    copies its query lanes and the query's length once; no two copies of
    a pass share a buffer word, every copy lands inside the warp's buffer
    where the compare reads it."""
    p = key_search.block_plan(n_keys, key_words)
    stages = ref.block_stage_words(p)
    assert len(stages) == p.chunks
    keys_seen, lens_seen, valid_seen = [], [], []
    for c, passes in enumerate(stages):
        assert len(passes) == p.spans
        i0 = c * p.chunk
        n = min(p.chunk, n_keys - i0)
        for k, (lane, src, idx, dst) in enumerate(passes):
            w0 = (p.spans - 1 - k) * p.span
            ws = min(p.span, key_words - w0)
            assert bool(((lane >= 0) & (lane < 32)).all())
            assert torch.unique(dst).numel() == dst.numel()
            assert bool((dst < p.warp_words).all())
            qy = src == ref.STAGE_QUERY
            assert torch.equal(idx[qy], w0 + torch.arange(ws))
            assert torch.equal(dst[qy], torch.arange(ws))
            assert torch.equal(dst[src == ref.STAGE_QLEN],
                               torch.tensor([p.span]))
            key = src == ref.STAGE_KEY
            i, w = idx[key] // key_words - i0, idx[key] % key_words - w0
            assert bool(((w >= 0) & (w < ws) & (i >= 0) & (i < n)).all())
            assert torch.equal(dst[key], p.head + i * p.stride + w)
            keys_seen.append(idx[key])
            for s_, off, seen in ((ref.STAGE_LEN, p.span, lens_seen),
                                  (ref.STAGE_VALID, p.span + 1,
                                   valid_seen)):
                sel = src == s_
                assert bool(sel.any()) == (k == 0)
                assert torch.equal(dst[sel], p.head + (idx[sel] - i0)
                                   * p.stride + off)
                seen.append(idx[sel])
    for seen, n in ((keys_seen, n_keys * key_words), (lens_seen, n_keys),
                    (valid_seen, n_keys)):
        assert torch.equal(torch.sort(torch.cat(seen)).values,
                           torch.arange(n))


@pytest.mark.parametrize("case", [f"{n}x{kw}" for n, kw in BLOCK_SEARCH])
def test_block_mirror_matches_plain_and_reference(case):
    """The search as the kernel stages, chunks and passes it equals the
    plain version and the reference's oracle and interpret-mode Pallas
    kernel, with valid masks all zero, full and not a prefix."""
    n, kw = map(int, case.split("x"))
    q, qlen, keys, klens, valid = _block_case(n, kw)
    args = [_t(a) for a in (q, qlen, keys, klens, valid)]
    want = ref.key_search_ref(*args)
    got = ref.key_search_block_mirror(*args, key_search.block_plan(n, kw))
    assert got.dtype == torch.int32 and torch.equal(want, got)
    jr = jref.key_search_ref(*map(jnp.asarray, (q, qlen, keys, klens,
                                                valid)))
    ji = jops.key_search(q, qlen, keys, klens, valid, backend="interpret",
                         block_b=4)
    np.testing.assert_array_equal(want.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(want.numpy(), np.asarray(ji))
    assert bool((want >= 0).any()) and bool((want[:1] == -1).all())


@pytest.mark.parametrize("B,N,KW,lane_hi", [
    (8, 16, 4, 60), (128, 64, 8, 60), (50, 8, 2, 60), (3, 80, 8, 60),
    (64, 64, 8, 2 ** 32), (40, 8, 8, 2 ** 32)])
def test_block_mirror_on_the_reference_sweep(B, N, KW, lane_hi):
    """The reference's own floor-search sweep through the mirror, equal
    to the plain version."""
    args = [_t(a) for a in _search_case(B, N, KW, B + N, lane_hi)]
    want = ref.key_search_ref(*args)
    got = ref.key_search_block_mirror(*args, key_search.block_plan(N, KW))
    assert torch.equal(want, got)


# ---- leaf merge -------------------------------------------------------------

@pytest.mark.parametrize("log_cap", [0, 1, 4, 16, 17, 32, 33, 40, 1536])
def test_merge_plan_instances_and_budgets(log_cap):
    """A half-warp a leaf up to 16 log entries (two leaves a warp), the
    generic instance beyond, its shared memory under 48 KB
    across the whole domain (node_cap + 2 * log_cap <= 3,072); outside
    the domain the plan raises before any launch."""
    node_cap = leaf_merge.MAX_SHARED_WORDS - 2 * log_cap
    for n in {n for n in (0, 3, 64, node_cap) if n <= node_cap}:
        p = leaf_merge.merge_plan(n, log_cap)
        if log_cap <= 16:
            assert (p.group, p.leaves) == (16, 2 * p.warps)
        else:
            assert (p.group, p.leaves) == (0, p.warps)
            assert p.smem_bytes == 12 * p.warps * log_cap
        assert p.group == 0 or p.group >= log_cap
        assert p.smem_bytes <= SMEM_LIMIT and 1 <= p.warps <= 8
    with pytest.raises(ValueError):
        leaf_merge.merge_plan(node_cap + 1, log_cap)
    with pytest.raises(ValueError):
        leaf_merge.merge_plan(-1, log_cap)


def _check_merge(nitems, nlog, backptr, hints, N, L, reference=True):
    """The mirror against the plain version, a permutation in all T
    positions, and (``reference``) the reference's oracle and its
    interpret-mode Pallas kernel."""
    args = [_t(a) for a in (nitems, nlog, backptr, hints)]
    wp, wv = ref.leaf_merge_ref(*args, node_cap=N, log_cap=L)
    mp, mv = ref.leaf_merge_mirror(*args, node_cap=N, log_cap=L)
    assert mp.dtype == mv.dtype == torch.int32
    assert torch.equal(wp, mp) and torch.equal(wv, mv)
    B = nitems.shape[0]
    assert torch.equal(mp.sort(dim=1).values,
                       torch.arange(N + L, dtype=torch.int32).expand(B, -1))
    if reference:
        jp, jv = jref.leaf_merge_ref(*map(jnp.asarray, (nitems, nlog,
                                                        backptr, hints)),
                                     node_cap=N, log_cap=L)
        ip, iv = jops.leaf_merge(nitems, nlog, backptr, hints, node_cap=N,
                                 log_cap=L, backend="interpret", block_b=8)
        for p, v in ((jp, jv), (ip, iv)):
            np.testing.assert_array_equal(mp.numpy(), np.asarray(p))
            np.testing.assert_array_equal(mv.numpy(), np.asarray(v))


@pytest.mark.parametrize("B,N,L", MERGE_SWEEP)
def test_merge_mirror_on_the_reference_sweep(B, N, L):
    """The reference's leaves (live counts, back pointers and hints in
    range) through the O(T * L) placement."""
    _check_merge(*_merge_case(B, N, L, B + N + L), N, L)


@pytest.mark.parametrize("N,L", [(8, 1), (64, 16), (16, 16), (64, 32),
                                 (64, 33), (40, 40), (0, 5), (3, 33)])
def test_merge_mirror_on_wild_leaves(N, L):
    """Counts in [-3, cap + 4], back pointers and hints over the whole
    int32 range (ranks that wrap), a live log rank forced to INT32_MAX,
    one forced equal to a sorted rank (the sorted slot goes first), two
    log ranks forced equal (the earlier slot goes first)."""
    _check_merge(*_wild_merge_case(40, N, L, N + L), N, L)


@pytest.mark.parametrize("L", [1, 16, 32, 33, 40])
def test_merge_mirror_at_the_stores_node_cap(L):
    """The default geometry's 64 sorted slots beside wild log blocks at
    the register instance's edge and past it (the generic instance), on the
    port's plain version alone (more leaves than the reference checks)."""
    _check_merge(*_wild_merge_case(300, 64, L, L + 7), 64, L,
                 reference=False)
