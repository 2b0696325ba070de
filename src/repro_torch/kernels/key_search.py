"""KSU floor search on the GPU (port of ``repro.kernels.key_search``:
``key_search`` and ``key_search_image``).

The key search unit (paper Section 4.2) finds, per request, the largest
candidate key <= the query within one block of a node: the shortcut
block or the sorted block.  ``key_search`` takes the candidates as
separate operands; ``key_search_image`` reads them out of each request's
packed node-image row at the layout's static word offsets
(``core/schema.NodeImageLayout.offsets``).  Both launch
``csrc/key_search.cu``, one warp per request.  Keys are int32 bit views of
big-endian u32 lanes; the kernel compares them as unsigned words.

Both modes stage each request's query and candidate block (with the
image's count word, or the valid mask) in a warp's shared-memory buffer
in one burst before they compare; ``image_plan`` and ``block_plan`` size
that buffer, and a block too large for it is searched in chunks.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # q, qlen, keys, klens, valid, out, B, N, KW, warps, chunk, span, stream
    "key_search_launch": [_P] * 6 + [_I] * 6 + [_P],
    # q, qlen, img, out, B, IW, keys_off, lens_off, count_off, n_keys, KW,
    # warps, chunk, stream
    "key_search_image_launch": [_P] * 4 + [_I] * 9 + [_P],
}

#: warps (requests) per block of the image-mode kernel; the kernel takes
#: 1 to 4 (csrc/key_search.cu kMaxWarps)
IMAGE_WARPS = 2
#: the words one warp's buffer may hold (key_search.cu kWarpWords):
#: 4 warps of 8 KB stay below the 48 KB a block takes without opt-in
IMAGE_WARP_WORDS = 2048
#: warps (requests) per block of the block-mode kernel, 1 to 4
BLOCK_WARPS = 2
#: the words one warp's buffer may hold in block mode (kWarpWords too)
BLOCK_WARP_WORDS = IMAGE_WARP_WORDS


@dataclasses.dataclass(frozen=True)
class ImagePlan:
    """How the image-mode kernel stages one request's candidate block of
    ``n_keys`` keys of ``key_words`` lanes: ``warps`` requests a block,
    each warp's buffer holds the count word, the query's length and lanes,
    then ``chunk`` candidates at ``stride`` words apart (the lanes, the
    length, a pad to an odd stride); the block is staged and compared in
    ``chunks`` chunks.  ``smem_bytes`` is the block's shared memory."""
    n_keys: int
    key_words: int
    warps: int
    chunk: int
    chunks: int
    stride: int
    warp_words: int
    smem_bytes: int


@functools.lru_cache(maxsize=64)
def image_plan(n_keys: int, key_words: int) -> ImagePlan:
    """The image-mode kernel's plan: the whole block in one chunk where it
    fits a warp's ``IMAGE_WARP_WORDS``, else the most candidates that fit
    (the default geometry's sorted block, 64 keys of 8 lanes, takes 586
    words).  Raises ValueError where not even one candidate fits beside
    the query (``key_words`` above 1,022)."""
    if n_keys < 1 or key_words < 1:
        raise ValueError(f"need n_keys >= 1 and key_words >= 1, got "
                         f"{n_keys} and {key_words}")
    stride = (key_words + 1) | 1
    room = (IMAGE_WARP_WORDS - 2 - key_words) // stride
    if room < 1:
        raise ValueError(f"keys of {key_words} lanes do not fit the image "
                         f"kernel's {IMAGE_WARP_WORDS}-word warp buffer")
    chunk = min(n_keys, room)
    warp_words = 2 + key_words + chunk * stride
    return ImagePlan(n_keys, key_words, IMAGE_WARPS, chunk,
                     -(-n_keys // chunk), stride, warp_words,
                     4 * IMAGE_WARPS * warp_words)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """How the block-mode kernel stages one request's ``n_keys``
    candidates of ``key_words`` lanes, ``warps`` requests a block.  A pass
    stages ``chunk`` candidates' lanes ``[w0, w0 + span)``: each warp's
    buffer holds the query's lanes of the pass and its length in ``head``
    words, then the candidates at ``stride`` words apart (the lanes, the
    length, the valid word, a pad to an odd stride).  The block takes
    ``chunks`` chunks of ``spans`` passes each (one, unless a key outgrows
    the buffer: then at most 32 candidates a chunk).  ``smem_bytes`` is the
    block's shared memory."""
    n_keys: int
    key_words: int
    warps: int
    chunk: int
    chunks: int
    span: int
    spans: int
    head: int
    stride: int
    warp_words: int
    smem_bytes: int


def _block_words(span: int, chunk: int) -> tuple:
    """(head, stride, warp words) of a pass (key_search.cu
    ``block_stride``, ``block_warp_words``)."""
    head, stride = span + 1, (span + 2) | 1
    return head, stride, head + chunk * stride


@functools.lru_cache(maxsize=64)
def block_plan(n_keys: int, key_words: int) -> BlockPlan:
    """The block-mode kernel's plan: the whole key a pass and the whole
    block in one chunk where they fit a warp's ``BLOCK_WARP_WORDS`` (the
    default geometry's sorted block, 64 keys of 8 lanes, takes 713
    words), else the most candidates that fit; a key too wide for one
    candidate beside the query is taken 32 candidates a chunk, in passes
    of the most lanes that fit."""
    if n_keys < 1 or key_words < 1:
        raise ValueError(f"need n_keys >= 1 and key_words >= 1, got "
                         f"{n_keys} and {key_words}")
    head, stride, _ = _block_words(key_words, 0)
    room = (BLOCK_WARP_WORDS - head) // stride
    if room >= 1:
        span, chunk = key_words, min(n_keys, room)
    else:
        chunk = min(n_keys, 32)
        span = max(s for s in range(1, key_words)
                   if _block_words(s, chunk)[2] <= BLOCK_WARP_WORDS)
    head, stride, warp_words = _block_words(span, chunk)
    return BlockPlan(n_keys, key_words, BLOCK_WARPS, chunk,
                     -(-n_keys // chunk), span, -(-key_words // span), head,
                     stride, warp_words, 4 * BLOCK_WARPS * warp_words)


def key_search(q: torch.Tensor, qlen: torch.Tensor, keys: torch.Tensor,
               klens: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Floor search on CUDA: the largest ``i`` with ``valid[b, i]`` and
    ``keys[b, i] <= q[b]``, else -1.

    q:     [B, KW] int32 query lanes (u32 bit views)
    qlen:  [B] int32 byte lengths
    keys:  [B, N, KW] int32 candidate lanes
    klens, valid: [B, N] int32
    Returns [B] int32."""
    build.check_tensor(keys, "keys", 3, dtype=torch.int32)
    for t, name, nd in ((q, "q", 2), (qlen, "qlen", 1), (klens, "klens", 2),
                        (valid, "valid", 2)):
        build.check_tensor(t, name, nd, keys.device, torch.int32)
    B, N, KW = keys.shape
    if (q.shape != (B, KW) or qlen.shape != (B,) or klens.shape != (B, N)
            or valid.shape != (B, N)):
        raise ValueError(f"need q [{B}, {KW}], qlen [{B}], klens and valid "
                         f"[{B}, {N}] for keys {tuple(keys.shape)}")
    if N < 1 or KW < 1:
        raise ValueError(f"need at least one candidate of one lane, got "
                         f"keys {tuple(keys.shape)}")
    plan = block_plan(N, KW)
    out = torch.empty(B, dtype=torch.int32, device=keys.device)
    if B == 0:
        return out
    with torch.cuda.device(keys.device):   # the launcher uses it
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = build.launcher("key_search", "key_search_launch",
                             _ARGTYPES["key_search_launch"])(
            q.data_ptr(), qlen.data_ptr(), keys.data_ptr(), klens.data_ptr(),
            valid.data_ptr(), out.data_ptr(), B, N, KW, plan.warps,
            plan.chunk, plan.span, stream)
    build.check(err, "key_search")
    build.LAUNCHES["key_search"] += 1
    return out


def key_search_image(q: torch.Tensor, qlen: torch.Tensor,
                     node_img: torch.Tensor, *, keys_off: int, lens_off: int,
                     count_off: int, n_keys: int,
                     key_words: int) -> torch.Tensor:
    """Floor search on CUDA over a candidate block inside packed node
    images: request ``b`` searches the ``n_keys`` keys of ``key_words``
    lanes at word ``keys_off`` of ``node_img[b]``, their lengths at
    ``lens_off`` and the live count (signed) at ``count_off``.

    q:        [B, key_words] int32 query lanes (u32 bit views)
    qlen:     [B] int32 byte lengths
    node_img: [B, IW] int32 image rows, one per request
    Returns [B] int32 floor indices, -1 where no live key <= the query."""
    build.check_tensor(node_img, "node_img", 2, dtype=torch.int32)
    build.check_tensor(q, "q", 2, node_img.device, torch.int32)
    build.check_tensor(qlen, "qlen", 1, node_img.device, torch.int32)
    B, IW = node_img.shape
    if q.shape != (B, key_words) or qlen.shape != (B,):
        raise ValueError(f"need q [{B}, {key_words}] and qlen [{B}], got "
                         f"{tuple(q.shape)} and {tuple(qlen.shape)}")
    if (n_keys < 1 or key_words < 1 or min(keys_off, lens_off, count_off) < 0
            or keys_off + n_keys * key_words > IW
            or lens_off + n_keys > IW or count_off >= IW):
        raise ValueError(f"a block of {n_keys} keys x {key_words} words at "
                         f"keys_off={keys_off}, lens_off={lens_off}, "
                         f"count_off={count_off} does not fit rows of {IW} "
                         f"words")
    plan = image_plan(n_keys, key_words)
    out = torch.empty(B, dtype=torch.int32, device=node_img.device)
    if B == 0:
        return out
    with torch.cuda.device(node_img.device):
        stream = torch.cuda.current_stream(node_img.device).cuda_stream
        err = build.launcher("key_search", "key_search_image_launch",
                             _ARGTYPES["key_search_image_launch"])(
            q.data_ptr(), qlen.data_ptr(), node_img.data_ptr(),
            out.data_ptr(), B, IW, keys_off, lens_off, count_off, n_keys,
            key_words, plan.warps, plan.chunk, stream)
    build.check(err, "key_search_image")
    build.LAUNCHES["key_search_image"] += 1
    return out
