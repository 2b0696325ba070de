"""honeylint for the port — repo-specific static analysis, a CUDA kernel
audit and the epoch sanitizer (port of ``repro.analysis``).

Three parts, one command (``python -m repro_torch.analysis``):

  * ``analysis/lint.py``         — AST lint pass over ``src/repro_torch``
    + the golden schema hash
  * ``analysis/kernel_check.py`` — dispatch audit of every entry point of
    ``kernels/ops.py`` (the CUDA counterpart of the reference's jaxpr
    audit) + a scan of the CUDA sources
  * ``analysis/epochsan.py``     — env-gated runtime sanitizer
    (``HONEYCOMB_EPOCHSAN=1``) for the epoch/snapshot protocol

Each port rule beside the reference rule it stands for (rule ids, the
violation kinds and ``EpochSanStats`` fields keep the reference's names
where the meaning carries):

====================== ====================== ===============================
port rule id           reference rule         what the port checks
====================== ====================== ===============================
no-raw-clock           no-raw-clock           time.time()/perf_counter()
                                              outside core/telemetry.py,
                                              which owns CLOCK
no-aliased-publish     no-aliased-publish     in a publish function of
                                              core/{shard,replica,read_path}
                                              .py: torch.from_numpy/as_tensor
                                              of a live host array with no
                                              .clone() or .to(..., copy=True)
                                              after it, and .to(dev) without
                                              copy=True (aliases on the CPU)
no-magic-image-offsets no-magic-image-offsets integer-literal packed-image
                                              offsets in the port's Python
                                              kernels; the ``.cu`` sources
                                              are out of reach of ``ast``
                                              (their offsets arrive from
                                              NodeImageLayout through the
                                              wrappers' geometry arrays)
stats-must-collect     stats-must-collect     *Stats dataclass without
                                              collect()
no-bare-except         no-bare-except         bare/over-broad except
schema-golden-drift    schema-golden-drift    NODE_SCHEMA / wire-codec drift
                                              of repro_torch.core against
                                              the port's own golden copy
kernel-no-f64          kernel-no-f64          float64/complex128 on any aten
                                              op of a dispatch; ``double`` in
                                              kernels/csrc/*.cu* (comments
                                              stripped)
kernel-host-readback   kernel-no-callback     more device->host read-backs a
                                              dispatch than its pinned count
                                              (on the card)
kernel-inplace-alias   kernel-inplace-alias   an in-place scatter returning
                                              other storage than its
                                              destination, or its peak
                                              allocation rising by a whole
                                              destination (on the card)
kernel-single-dispatch kernel-single-dispatch a fused GET/SCAN batch adding
                                              other than exactly 1 to its own
                                              LAUNCHES counter and 0 to the
                                              others (on the card)
kernel-smem-budget     kernel-vmem-budget     a launch's dynamic shared
                                              memory above the device's
                                              per-block opt-in limit
standby-read           standby-read           EpochSan, same rule
pinned-epoch-gc        pinned-epoch-gc        EpochSan, same rule
follower-freshness     follower-freshness     EpochSan, same rule
stale-cache-rows       stale-cache-rows       EpochSan, same rule
unflipped-standby-     unflipped-standby-     EpochSan, same rule
after-export           after-export
====================== ====================== ===============================

Import is deliberately lazy: ``repro_torch.core`` modules import
``repro_torch.analysis.epochsan`` for the seam hooks, so this package
must load with nothing of ``repro_torch.core`` imported yet.  Nothing
here imports ``jax`` or ``repro``.
"""
from __future__ import annotations

__all__ = ["lint", "kernel_check", "epochsan", "runner"]


def __getattr__(name):
    if name in __all__:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
