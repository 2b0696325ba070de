"""The delta-sync row copy's plan and its CPU mirror, without a card and
without JAX.  ``delta_scatter.scatter_plan`` sizes the blocks of the copy
that both scatter kernels run over the flattened row
(``csrc/scatter_rows.cuh``); ``ref.flat_scatter_mirror`` walks the same
(block, chunk, k, thread) assignment, with the kernel's field search and
its skip of a repeated row, and writes through it.  The plan must cover
every word of every field once, in schema order, and the mirror must
equal the plain scatters (tolerance 0: integers).  The inputs come from
``tests/test_torch_cuda.py``'s case builder, which the card's tests
share."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import delta_scatter, ref
from test_torch_cuda import SCATTER_ROWS, SCATTER_WIDTHS, _flat_case


@pytest.mark.parametrize("D", [1, 5, 33])
@pytest.mark.parametrize("shape", sorted(SCATTER_WIDTHS))
def test_plan_covers_every_word_once_in_schema_order(shape, D):
    widths = SCATTER_WIDTHS[shape]
    plan = delta_scatter.scatter_plan(widths, D)
    i, f, j, live = ref.flat_scatter_words(plan)
    i, f, j = i[live], f[live], j[live]
    W = sum(widths)
    assert i.numel() == D * W
    off = torch.tensor(plan.offsets)
    width = torch.tensor(widths)
    assert bool((j >= 0).all()) and bool((j < width[f]).all())
    # every (row, field, word) once: the flattened word is a bijection
    flat = i * W + off[f] + j
    assert torch.equal(torch.sort(flat).values, torch.arange(D * W))
    # in schema order: the slot's word within the row is its position in
    # the flattened row
    K, T = plan.k, plan.threads
    _, c, k, t = torch.meshgrid(
        torch.arange(plan.grid), torch.arange(plan.chunks),
        torch.arange(K), torch.arange(T), indexing="ij")
    w = (c * K * T + k * T + t)[live]
    assert torch.equal(w, off[f] + j)


def test_plan_at_the_default_geometry():
    """The store's timed delta: 1,024 rows of 1,273 words, packed or in the
    legacy layout's 24 fields, one block of 160 threads a row, K = 8."""
    for widths in (SCATTER_WIDTHS["packed"], SCATTER_WIDTHS["legacy"]):
        plan = delta_scatter.scatter_plan(widths, 1024)
        assert (plan.k, plan.threads, plan.grid, plan.chunks) == \
            (8, 160, 1024, 1)
        assert plan.offsets[-1] == 1273


@pytest.mark.parametrize("W", [1, 7, 31, 32, 33, 100, 255, 256, 257, 1000,
                               1273, 2048, 4095, 4096, 4097, 5000, 20000])
def test_plan_stays_within_its_budgets(W):
    """K words a thread within the register budget the plan states, whole
    warps of at most 256 threads, one block a row, chunks that cover the
    row, and one chunk wherever a row fits in K * threads words."""
    plan = delta_scatter.scatter_plan((W,), 64)
    assert plan.k in delta_scatter.K_CHOICES
    assert plan.k * 4 <= plan.reg_bytes
    assert plan.threads % 32 == 0
    assert 32 <= plan.threads <= delta_scatter.MAX_THREADS
    assert (plan.chunks - 1) * plan.k * plan.threads < W \
        <= plan.chunks * plan.k * plan.threads
    assert plan.grid == 64
    if W <= delta_scatter.K_CHOICES[-1] * delta_scatter.MAX_THREADS:
        assert plan.chunks == 1


def test_plan_rejects_bad_fields():
    with pytest.raises(ValueError):
        delta_scatter.scatter_plan((), 4)
    with pytest.raises(ValueError):
        delta_scatter.scatter_plan((1,) * 33, 4)
    with pytest.raises(ValueError):
        delta_scatter.scatter_plan((0, 0), 4)
    with pytest.raises(ValueError):
        delta_scatter.scatter_plan((4, -1), 4)


def _torch(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("kind", SCATTER_ROWS)
@pytest.mark.parametrize("shape", sorted(SCATTER_WIDTHS))
def test_mirror_equals_the_plain_scatters(shape, kind):
    """Over the fields (the multi-field scatter) and over the same fields
    as one packed row (the row scatter), the mirror equals the plain
    version and numpy's ``dst[rows] = upd``."""
    widths = SCATTER_WIDTHS[shape]
    dsts, rows, upd = _flat_case(widths, kind)
    numpy_out = [a.copy() for a in dsts]
    for a, u in zip(numpy_out, upd):
        a[rows] = u
    rows_t = torch.from_numpy(rows)
    plan = delta_scatter.scatter_plan(widths, len(rows))
    want = ref.snapshot_multi_scatter_ref(_torch(dsts), rows_t, _torch(upd))
    got = ref.flat_scatter_mirror(_torch(dsts), rows_t, _torch(upd), plan)
    for w, g, n in zip(want, got, numpy_out):
        assert torch.equal(w, g) and np.array_equal(g.numpy(), n)
    image = np.concatenate(dsts, axis=1)
    packed = np.concatenate(upd, axis=1)
    plan = delta_scatter.scatter_plan((image.shape[1],), len(rows))
    want = ref.snapshot_image_scatter_ref(torch.from_numpy(image.copy()),
                                          rows_t, torch.from_numpy(packed))
    got, = ref.flat_scatter_mirror([torch.from_numpy(image.copy())], rows_t,
                                   [torch.from_numpy(packed)], plan)
    assert torch.equal(want, got)
    assert np.array_equal(got.numpy(), np.concatenate(numpy_out, axis=1))


def test_mirror_skips_a_repeat_of_its_predecessor():
    """A row equal (after wrapping) to its predecessor is neither loaded
    nor stored: given different data, which the contract forbids, the
    first row of the run wins; a repeat that is not a neighbour is
    written again, so the last one wins."""
    widths = SCATTER_WIDTHS["legacy"]
    S = 16
    rows = torch.tensor([3, 3, -13, 5, 3], dtype=torch.int32)
    upd = [torch.arange(5 * w, dtype=torch.int32).reshape(5, w) + 1
           for w in widths]
    dsts = [torch.zeros(S, w, dtype=torch.int32) for w in widths]
    plan = delta_scatter.scatter_plan(widths, 5)
    got = ref.flat_scatter_mirror(dsts, rows, upd, plan)
    for g, u in zip(got, upd):
        assert torch.equal(g[3], u[4]) and torch.equal(g[5], u[3])
    got = ref.flat_scatter_mirror([torch.zeros(S, w, dtype=torch.int32)
                                   for w in widths], rows[:3],
                                  [u[:3] for u in upd],
                                  delta_scatter.scatter_plan(widths, 3))
    for g, u in zip(got, upd):
        assert torch.equal(g[3], u[0])        # rows 1 and 2 were skipped


def test_mirror_skips_rows_out_of_range():
    """The kernel's last guard: a row outside [-S, S) writes nothing (the
    wrappers raise before they launch); the other rows are written."""
    S, W = 8, 300
    image = torch.zeros(S, W, dtype=torch.int32)
    rows = torch.tensor([1, 8, -9, -1], dtype=torch.int32)
    upd = torch.arange(4 * W, dtype=torch.int32).reshape(4, W) + 1
    plan = delta_scatter.scatter_plan((W,), 4)
    got, = ref.flat_scatter_mirror([image], rows, [upd], plan)
    assert torch.equal(got[1], upd[0]) and torch.equal(got[7], upd[3])
    assert int(got.count_nonzero()) == 2 * W
