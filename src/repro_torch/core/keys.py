"""Key packing and comparison (port of ``repro.core.keys``).

Keys pack big-endian into uint32 lanes so that lexicographic *byte* order
equals lexicographic *lane* order (unsigned), with key length as the tie
break for prefix relationships.  A comparison is then a vectorized lane
compare plus a first-difference select.

Host helpers use numpy.  ``torch_key_cmp``, ``torch_key_less`` and
``torch_key_leq`` are the batched device twins of the reference's
``jax_key_cmp``, ``jax_key_less`` and ``jax_key_leq``.  PyTorch's
``uint32`` lacks comparison and gather kernels on the CPU, so the port
carries every key lane as the ``int32`` bit view of its u32 word and
compares unsigned words by flipping the sign bit first (``x ^
INT32_MIN`` maps unsigned order onto signed order).
"""
from __future__ import annotations

import numpy as np
import torch

INT32_MIN = -(2 ** 31)


def pack_key(key: bytes, key_words: int) -> np.ndarray:
    """Pack bytes big-endian into uint32 lanes, zero padded."""
    if len(key) > key_words * 4:
        raise ValueError(f"key of {len(key)} bytes exceeds {key_words * 4}")
    buf = key + b"\x00" * (key_words * 4 - len(key))
    return np.frombuffer(buf, dtype=">u4").astype(np.uint32)


def unpack_key(lanes: np.ndarray, length: int) -> bytes:
    """The first ``length`` bytes of big-endian packed lanes (u32 words or
    their int32 bit views)."""
    buf = np.asarray(lanes).astype(">u4").tobytes()
    return buf[:length]


def pack_keys(keys: list[bytes], key_words: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack a batch of keys -> (lanes [B, KW] uint32, lengths [B] int32)."""
    lanes = np.stack([pack_key(k, key_words) for k in keys]) if keys else \
        np.zeros((0, key_words), np.uint32)
    lens = np.array([len(k) for k in keys], np.int32)
    return lanes, lens


# --- host comparisons (numpy scalars) ---------------------------------------

def key_cmp(a: np.ndarray, alen: int, b: np.ndarray, blen: int) -> int:
    """memcmp semantics over packed lanes: -1 / 0 / +1."""
    a = np.asarray(a, np.uint32)
    b = np.asarray(b, np.uint32)
    neq = a != b
    if neq.any():
        i = int(np.argmax(neq))
        return -1 if a[i] < b[i] else 1
    # identical padded lanes: shorter key is a strict prefix => smaller
    return (alen > blen) - (alen < blen)


def key_less(a, alen, b, blen) -> bool:
    return key_cmp(a, alen, b, blen) < 0


def key_leq(a, alen, b, blen) -> bool:
    return key_cmp(a, alen, b, blen) <= 0


# --- torch comparisons (broadcastable) ---------------------------------------

def torch_key_cmp(a: torch.Tensor, alen: torch.Tensor, b: torch.Tensor,
                  blen: torch.Tensor) -> torch.Tensor:
    """Vectorized memcmp: sign of comparison, broadcasting over leading dims.

    a: [..., KW] int32 bit views of u32 lanes, alen: [...] int32 (same for
    b).  Returns [...] int32 in {-1, 0, 1}, equal to ``jax_key_cmp`` on the
    u32 words."""
    a, b = torch.broadcast_tensors(a, b)
    neq = a != b
    any_neq = neq.any(dim=-1)
    first = neq.to(torch.uint8).argmax(dim=-1, keepdim=True)  # 0 if none
    av = torch.gather(a, -1, first)[..., 0] ^ INT32_MIN
    bv = torch.gather(b, -1, first)[..., 0] ^ INT32_MIN
    lane_sign = torch.where(av < bv, -1, 1).to(torch.int32)
    len_sign = torch.sign(alen - blen).to(torch.int32)
    return torch.where(any_neq, lane_sign, len_sign)


def torch_key_less(a, alen, b, blen) -> torch.Tensor:
    return torch_key_cmp(a, alen, b, blen) < 0


def torch_key_leq(a, alen, b, blen) -> torch.Tensor:
    return torch_key_cmp(a, alen, b, blen) <= 0


def int_key(x: int, width: int = 8) -> bytes:
    """Fixed-width big-endian integer key (sorts numerically)."""
    return int(x).to_bytes(width, "big")
