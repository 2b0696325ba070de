"""The plans of the image-mode floor search and the log replay, and their
CPU mirrors, without a card and without JAX.  ``key_search.image_plan``
sizes the shared-memory buffer into which a warp of
``csrc/key_search.cu`` stages one request's count, query and candidate
block; ``ref.image_stage_words`` walks its copies and
``ref.key_search_image_mirror`` searches through them.
``delta_scatter.replay_plan`` sizes the blocks of ``csrc/log_replay.cu``;
``ref.replay_pairs`` walks every block's pass over the (row, slot)
pairs and ``ref.replay_verdict`` is the range verdict the kernel writes
to its flag.  Every word must be staged once, every entry and pair
covered once, the mirrors must equal the plain versions (tolerance 0:
integers).  The inputs come from ``tests/test_torch_cuda.py``'s case
builders, which the card's tests share."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import HoneycombConfig
from repro_torch.kernels import delta_scatter, key_search, ref
from test_torch_cuda import (IMAGE_BLOCKS, SMALL, WILD_IMAGE, _image_case,
                             _wild_image_case)

SMEM_LIMIT = 48 * 1024          # a block's shared memory without opt-in

#: (n_keys, key_words) of the stores' blocks: the default geometry's and
#: SMALL's sorted and shortcut blocks, then the synthetic cases
IMAGE_SHAPES = sorted({(getattr(cfg, IMAGE_BLOCKS[b][3]), cfg.key_words)
                       for cfg in (HoneycombConfig(), SMALL)
                       for b in IMAGE_BLOCKS} | set(WILD_IMAGE))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("n_keys,key_words", IMAGE_SHAPES)
def test_image_plan_stages_every_word_once(n_keys, key_words):
    """Over all chunks the burst copies the count word, the query's length,
    each query lane, each key word and each length of the block once; in
    a chunk no two copies share a buffer word, every copy lands inside
    the warp's buffer, and candidate i's lanes and length sit at
    ``2 + KW + i * stride + w``, where the compare reads them."""
    plan = key_search.image_plan(n_keys, key_words)
    stages = ref.image_stage_words(plan)
    assert len(stages) == plan.chunks
    seen = {s: [] for s in range(5)}
    KW, ST = key_words, plan.stride
    for c, (lane, src, idx, dst) in enumerate(stages):
        assert bool(((lane >= 0) & (lane < 32)).all())
        assert torch.unique(dst).numel() == dst.numel()
        assert bool((dst < plan.warp_words).all())
        i0 = c * plan.chunk
        key = src == ref.STAGE_KEY
        assert torch.equal(dst[key], 2 + KW + (idx[key] // KW - i0) * ST
                           + idx[key] % KW)
        ln = src == ref.STAGE_LEN
        assert torch.equal(dst[ln], 2 + KW + (idx[ln] - i0) * ST + KW)
        for s in seen:
            seen[s].append(idx[src == s])
    want = {ref.STAGE_COUNT: 1, ref.STAGE_QLEN: 1,
            ref.STAGE_QUERY: KW, ref.STAGE_KEY: n_keys * KW,
            ref.STAGE_LEN: n_keys}
    for s, n in want.items():
        got = torch.sort(torch.cat(seen[s])).values
        assert torch.equal(got, torch.arange(n) if n > 1 else
                           torch.zeros(1, dtype=torch.long)), s


def test_image_plan_at_the_stores_blocks():
    """The default geometry's sorted block (64 keys of 8 lanes) and
    shortcut block (8 keys) each take one chunk: 586 and 82 words a warp,
    2 warps a block."""
    sorted_ = key_search.image_plan(64, 8)
    assert (sorted_.chunk, sorted_.chunks, sorted_.stride,
            sorted_.warp_words, sorted_.warps) == (64, 1, 9, 586, 2)
    assert sorted_.smem_bytes == 4 * 2 * 586
    shortcut = key_search.image_plan(8, 8)
    assert (shortcut.chunks, shortcut.warp_words) == (1, 82)
    chunked = key_search.image_plan(300, 8)
    assert (chunked.chunk, chunked.chunks) == (226, 2)


@pytest.mark.parametrize("n_keys", [1, 8, 64, 226, 227, 1000, 100_000])
def test_image_plan_shared_memory_stays_under_48kb(n_keys):
    """Every key width the wrapper accepts (1 to 1,022 lanes) fits a
    warp's buffer with at least one candidate, odd strides only, the
    block under 48 KB; a wider key is refused before any launch."""
    for kw in range(1, 1023):
        plan = key_search.image_plan(n_keys, kw)
        assert 1 <= plan.chunk <= n_keys
        assert plan.chunks * plan.chunk >= n_keys > \
            (plan.chunks - 1) * plan.chunk
        assert plan.stride % 2 == 1 and plan.stride >= kw + 1
        assert plan.warp_words <= key_search.IMAGE_WARP_WORDS
        assert plan.smem_bytes <= SMEM_LIMIT
    with pytest.raises(ValueError):
        key_search.image_plan(n_keys, 1023)


@pytest.mark.parametrize("case", [
    *(f"{g}-{b}-{top}" for g in ("default", "small") for b in IMAGE_BLOCKS
      for top in (0, 1)),
    *(f"wild-{n}x{kw}" for n, kw in WILD_IMAGE)])
def test_image_mirror_matches_plain(case):
    """The search as the kernel stages and chunks it equals the plain
    version: at the stores' blocks (counts with the top bit set too) and
    on the synthetic rows (two chunks, widths of the generic instance,
    counts of 0, above n_keys and negative, ties decided by length)."""
    kind, rest = case.split("-", 1)
    if kind == "wild":
        n, kw = map(int, rest.split("x"))
        q, qlen, img, kwargs = _wild_image_case(n, kw, n + kw)
    else:
        block, top = rest.split("-")
        cfg = HoneycombConfig() if kind == "default" else SMALL
        q, qlen, img, kwargs = _image_case(cfg, 40, 3, top == "1", block)
    q, qlen, img = _t(q), _t(qlen), _t(img)
    plan = key_search.image_plan(kwargs["n_keys"], kwargs["key_words"])
    got = ref.key_search_image_mirror(
        q, qlen, img, plan, keys_off=kwargs["keys_off"],
        lens_off=kwargs["lens_off"], count_off=kwargs["count_off"])
    want = ref.key_search_image_ref(q, qlen, img, **kwargs)
    assert got.dtype == torch.int32 and torch.equal(want, got)
    assert bool((got >= 0).any())


@pytest.mark.parametrize("D", [1, 4, 1024, 4096])
def test_replay_plan_covers_every_entry_and_pair_once(D):
    """The blocks' entry ranges partition [0, D); every block reads each
    of the D pairs once: held in registers up to 8 pairs, else walked in
    chunks of ``k * threads``."""
    plan = delta_scatter.replay_plan(D, 18)
    E = plan.entries
    blocks = [range(b * E, min((b + 1) * E, D)) for b in range(plan.grid)]
    assert all(len(r) for r in blocks)
    assert [i for r in blocks for i in r] == list(range(D))
    i, live = ref.replay_pairs(plan)
    assert torch.equal(torch.sort(i[live]).values, torch.arange(D))
    assert plan.held == (D <= delta_scatter.ENTRIES_PER_BLOCK)
    if not plan.held:
        assert i.shape == (plan.chunks, plan.k, plan.threads)
        assert bool((i[~live] >= D).all())
        assert plan.pair_chunk == plan.k * plan.threads
        assert (plan.chunks - 1) * plan.pair_chunk < D <= \
            plan.chunks * plan.pair_chunk


def test_replay_plan_at_the_path_shapes():
    """The replicated path's replays (D = 1 to 8) hold their pairs in
    registers, one entry and one warp a block; an epoch of about a
    thousand writes (D = 1,024) takes 128 blocks of 256 threads and one
    chunk of pairs; D = 4,096 512 blocks of 512 threads and two chunks."""
    for D in (1, 2, 4, 8):
        p = delta_scatter.replay_plan(D, 18)
        assert (p.held, p.grid, p.threads, p.entries) == (True, D, 32, 1)
    p9 = delta_scatter.replay_plan(9, 18)
    assert (p9.held, p9.grid, p9.threads, p9.entries) == (False, 2, 160, 8)
    p1k = delta_scatter.replay_plan(1024, 18)
    assert (p1k.grid, p1k.threads, p1k.chunks) == (128, 256, 1)
    p4k = delta_scatter.replay_plan(4096, 18)
    assert (p4k.grid, p4k.threads, p4k.chunks) == (512, 512, 2)


@pytest.mark.parametrize("EW", [1, 7, 18, 100, 700, 1400])
@pytest.mark.parametrize("D", [1, 5, 1024, 100_000])
def test_replay_plan_stays_within_its_budgets(EW, D):
    """Whole warps of 32 to 512 threads, the block's shared memory (its
    records and per-warp maxima) under 48 KB; records too wide for it are
    refused before any launch."""
    plan = delta_scatter.replay_plan(D, EW)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    E = delta_scatter.ENTRIES_PER_BLOCK
    assert plan.smem_bytes == 4 * E * (EW + plan.threads // 32)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.entries == (1 if D <= E else E)
    assert (plan.grid - 1) * plan.entries < D <= plan.grid * plan.entries
    assert plan.threads >= min(512, plan.entries * EW)
    with pytest.raises(ValueError):
        delta_scatter.replay_plan(D, 1600)


def _raises(fn, *args) -> bool:
    try:
        fn(*args)
    except IndexError:
        return True
    return False


@pytest.mark.parametrize("row", [None, 300, -301, 299, -300, 2 ** 31 - 1,
                                 -2 ** 31])
@pytest.mark.parametrize("slot", [None, -1, 4, 3, 0, 2 ** 31 - 1])
def test_replay_verdict_matches_the_plain_checks(row, slot):
    """Bit 0 of the verdict is set exactly when ``check_rows`` raises,
    bit 1 exactly when ``check_slots`` does (S = 300, log_cap = 4); the
    wrapper raises by those checks, rows first."""
    g = torch.Generator().manual_seed(0)
    rows = torch.randint(-300, 300, (40,), generator=g, dtype=torch.int32)
    slots = torch.randint(0, 4, (40,), generator=g, dtype=torch.int32)
    if row is not None:
        rows[17] = row
    if slot is not None:
        slots[31] = slot
    verdict = ref.replay_verdict(rows, slots, 300, 4)
    assert verdict & 1 == _raises(ref.check_rows, rows, 300)
    assert verdict >> 1 == _raises(ref.check_slots, slots, 4)
