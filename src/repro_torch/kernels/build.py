"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launcher.  ``load(name)``
compiles it with ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch/`` at the repository root (named by a hash of the
source and of the shared ``csrc/*.cuh`` headers, so an edited source or
header rebuilds) and loads it; ``launcher(name, fn, argtypes)`` binds one
of its C launchers, once, for every wrapper; ``build(names)`` starts one
``nvcc`` per missing library, all at once, and waits for them.  Nothing
is built when this module is imported.

``LAUNCHES`` holds one plain integer per kernel; each wrapper adds one
where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"fused_get": 0, "fused_scan": 0, "row_scatter": 0,
            "log_replay": 0, "multi_scatter": 0, "key_search": 0,
            "key_search_image": 0, "leaf_merge": 0, "paged_attention": 0,
            "moe_grouped": 0}

#: every CUDA source of the port, by name (``csrc/<name>.cu``)
SOURCES = ("fused_read", "row_scatter", "log_replay", "multi_scatter",
           "key_search", "leaf_merge", "paged_attention", "moe_grouped")

_LIBS: dict[str, ctypes.CDLL] = {}
_LAUNCHERS: dict[str, object] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source
    and of every header in ``csrc/`` (a source may include any of them)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names) -> dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all started together.  Returns the compiler's
    output (``-Xptxas -v`` register and shared-memory report) per source
    it built; raises if any compile fails."""
    jobs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT), tmp, so)
    reports, failed = {}, []
    for name, (proc, tmp, so) in jobs.items():
        out = proc.communicate()[0].decode(errors="replace")
        reports[name] = out
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def launcher(name: str, fn: str, argtypes: list):
    """The C launcher ``fn`` of ``csrc/<name>.cu``, its argument types set
    (``ctypes.c_void_p`` for pointers and the stream, ``ctypes.c_int`` for
    ints); it returns a CUDA error code."""
    f = _LAUNCHERS.get(fn)
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _LAUNCHERS[fn] = f
    return f


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def check_tensor(t, name: str, ndim: int, device=None, dtype=None) -> None:
    """A kernel argument must be a contiguous CUDA tensor of 32-bit words
    or bfloat16 of the given rank (on ``device`` and of ``dtype`` when
    they are named)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name} must lie on {device or 'a CUDA device'}, "
                         f"got {t.device}")
    if t.dtype not in (torch.int32, torch.uint32, torch.float32,
                       torch.bfloat16):
        raise ValueError(f"{name} must hold 4-byte elements or bfloat16, "
                         f"got {t.dtype}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
