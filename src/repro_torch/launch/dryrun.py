"""The cell dry run (port of ``repro.launch.dryrun``): each (arch x shape x
mesh) cell's step traced for one rank of the production mesh, with no
allocation and no communication, and its memory, cost and collectives
counted into the roofline terms.

The reference lowers and compiles every cell on 512 placeholder CPU
devices and reads XLA's analyses.  The port opens a fake process group of
256 (or 512) ranks in this one process (``FakeStore`` and the ``"fake"``
backend of the private ``torch.testing._internal.distributed.fake_pg``:
every collective returns at once and moves nothing), builds the
production ``DeviceMesh`` over it on the CPU, builds the step with
``launch/steps.build_step``, makes its arguments under ``FakeTensorMode``
(tensors with shapes and no data, each placed by ``built.in_shardings``
as rank 0's local block) and calls it once under
``launch/hlo_analysis``'s counters.  Nothing runs on any device: the
figures are rank 0's, as the reference's are one device's.

What differs from the reference:

* ``compile_s`` is the trace's seconds (there is no compile);
* the port loops over superblocks eagerly, so every layer is counted at
  full depth and the reference's one- and two-superblock extrapolation
  (``_reduced``) is not needed: no cell says ``"extrapolated"``;
* a decode cell's attention is the plain PyTorch paged attention (the
  CPU's route): the hand kernel is a custom op whose FLOPs
  ``FlopCounterMode`` does not see;
* a ragged MoE's group sizes are data, which a fake tensor does not
  hold: its rows are split evenly over the experts
  (``models/moe._group_sizes``), which moves no FLOP;
* the collective counts are the port's ``build_step``'s (weights gathered
  whole at use), not GSPMD's, and are not comparable with the
  reference's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape decode_32k --mesh single
  ... --policy ep --moe-impl ragged    # variants

It writes ``experiments/torch_dryrun.json`` in ``experiments/dryrun.json``'s
layout (``benchmarks/roofline.py:render`` reads that layout).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from ..configs import ALIASES, get_config
from ..core.telemetry import CLOCK
from ..distributed.sharding import ShardingPolicy
from ..launch import hlo_analysis as hla
from ..launch.mesh import make_production_mesh
from ..launch.steps import build_step
from ..models.config import LM_SHAPES, long_context_ok, shape_by_name
from ..models.schema import Spec
from ..train import optimizer as opt

DEFAULT_OUT = Path("experiments/torch_dryrun.json")
POLICIES = {
    "base": ShardingPolicy(),
    "ep": ShardingPolicy(expert_parallel=True),
    "noseqpages": ShardingPolicy(seq_parallel_pages=False),
    "localpages": ShardingPolicy(decode_impl="local"),
}
DECODE_ATTENTION = ("the plain PyTorch paged attention: FlopCounterMode "
                    "does not see into the hand kernel, a custom op")


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    destroyed on exit.  Refuses to run beside a process group already
    initialised (a real one must not be torn down or shadowed)."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: the "
                           "dry run opens a fake world of its own")
    # private: FakeStore and the "fake" backend it registers on import
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _contiguous_strides(shape) -> tuple:
    strides, n = [], 1
    for d in reversed(shape):
        strides.append(n)
        n *= d
    return tuple(reversed(strides))


def local_shape(shape, pl, mesh) -> tuple:
    """This rank's block of a tensor of ``shape`` under placements ``pl``:
    a dimension split over a mesh dimension of k ranks in chunks of
    ceil(n / k), as DTensor splits it, mesh dimensions in order."""
    coord = mesh.get_coordinate()
    local = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n, k = local[p.dim], mesh.size(i)
            c = -(-n // k)
            local[p.dim] = max(0, min(n - coord[i] * c, c))
    return tuple(local)


def _placed(spec: Spec, pl, mesh, make):
    """This rank's block of a value of ``spec`` under placements ``pl``, as
    a DTensor of the global shape; ``make(shape, dtype)`` makes the
    block."""
    local = local_shape(spec.shape, pl, mesh)
    return DTensor.from_local(make(local, spec.dtype), mesh, list(pl),
                              run_check=False, shape=torch.Size(spec.shape),
                              stride=_contiguous_strides(spec.shape))


def place_specs(specs, pls, mesh, make):
    """A tree of ``Spec`` leaves (dicts, tuples and named tuples, None) as
    DTensors placed by the matching tree of placement tuples."""
    if isinstance(specs, Spec):
        return _placed(specs, pls, mesh, make)
    if isinstance(specs, dict):
        return {k: place_specs(v, pls[k], mesh, make)
                for k, v in specs.items()}
    if isinstance(specs, tuple):
        vals = [place_specs(s, p, mesh, make) for s, p in zip(specs, pls)]
        return type(specs)(*vals) if hasattr(specs, "_fields") \
            else tuple(vals)
    if specs is None:
        return None
    raise TypeError(f"not a tree of specs: {type(specs)}")


def empty(shape, dtype):
    """A block with no values (a fake tensor under ``FakeTensorMode``)."""
    return torch.empty(shape, dtype=dtype)


def step_args(built, mesh, make=empty) -> tuple:
    """The arguments of ``built.fn`` on ``mesh``: the parameters, (train)
    the optimizer state ``opt.init`` makes of them and the batch, or the
    batch, or the cache, tokens (and encoder output), each from
    ``built.abstract_args`` placed by ``built.in_shardings``."""
    params = place_specs(built.abstract_args[0], built.in_shardings[0],
                         mesh, make)
    rest = tuple(place_specs(s, p, mesh, make) for s, p in
                 zip(built.abstract_args[1:], built.in_shardings[1:]))
    if len(built.abstract_args) == 3 and isinstance(
            built.abstract_args[1], opt.OptState):
        rest = (opt.init(params),) + rest[1:]
    return (params,) + rest


def trace_cell(cfg, shape, mesh, policy: ShardingPolicy = ShardingPolicy(),
               moe_impl: str = "dense", grad_accum: int = 4,
               make=None) -> hla.Trace:
    """One call of the cell's ``build_step`` on ``mesh`` under the
    counters, arguments from ``make`` (default: fake tensors, nothing
    allocated); the caller has opened the world."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    built = build_step(cfg, shape, mesh, policy=policy, moe_impl=moe_impl,
                       grad_accum=grad_accum)
    with contextlib.ExitStack() as stack:
        if make is None:
            stack.enter_context(FakeTensorMode())
        args = step_args(built, mesh, make or empty)
        return hla.trace(built.fn, args, built.donate_argnums)


def cell_record(cfg, shape, mesh_name: str, n_chips: int,
                tr: hla.Trace, seconds: float) -> dict:
    """The reference's record of a cell from one rank's trace."""
    mf = hla.model_flops_per_step(cfg, shape) / n_chips
    rl = hla.roofline(tr.cost, tr.collectives, mf)
    rec = {"mesh": mesh_name, "status": "ok", "compile_s": round(seconds, 1),
           "memory": tr.memory, "collectives": tr.collectives,
           "roofline": rl.to_dict()}
    if shape.kind == "decode":
        rec["attention"] = DECODE_ATTENTION
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             policy: ShardingPolicy, moe_impl: str,
             grad_accum: int = 4) -> dict:
    """The cell's step traced for rank 0 of the production mesh (16 x 16,
    or 2 x 16 x 16 with ``multi_pod``) in a fake world of that many ranks
    (see the module docstring)."""
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    n_chips = 512 if multi_pod else 256
    with fake_world(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        t0 = CLOCK()    # monotonic: compile_s is an interval
        tr = trace_cell(cfg, shape, mesh, policy, moe_impl, grad_accum)
        t1 = CLOCK()
    rec = cell_record(cfg, shape, "2x16x16" if multi_pod else "16x16",
                      n_chips, tr, t1 - t0)
    return {"arch": arch, "shape": shape_name, **rec}


def cells(archs, shapes):
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            sh = shape_by_name(s)
            if sh.name == "long_500k" and not long_context_ok(cfg):
                yield a, s, "skip", ("full-attention family: long_500k "
                                     "inapplicable (DESIGN.md Section 6)")
                continue
            yield a, s, "run", ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--policy", default="base", choices=list(POLICIES))
    ap.add_argument("--moe-impl", default="dense",
                    choices=["dense", "ragged", "ep_ragged", "fsliced"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--accum", type=int, default=4,
                    help="gradient-accumulation microbatches (train cells)")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    policy = POLICIES[args.policy]

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())

    archs = [args.arch] if args.arch else list(ALIASES.keys())
    shapes = [args.shape] if args.shape else [s.name for s in LM_SHAPES]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_fail = 0
    for arch, shape, what, why in cells(archs, shapes):
        for multi in meshes:
            key = f"{arch}|{shape}|{'multi' if multi else 'single'}"
            if args.policy != "base" or args.moe_impl != "dense":
                key += f"|{args.policy}|{args.moe_impl}"
            if args.tag:
                key += f"|{args.tag}"
            if key in results and results[key].get("status") == "ok" \
                    and not args.force:
                print(f"[cached] {key}")
                n_ok += 1
                continue
            if what == "skip":
                results[key] = {"arch": arch, "shape": shape,
                                "status": "skip", "reason": why}
                print(f"[skip]   {key}: {why}")
                n_skip += 1
            else:
                print(f"[run]    {key} ...", flush=True)
                try:
                    r = run_cell(arch, shape, multi, policy, args.moe_impl,
                                 grad_accum=args.accum)
                    r["policy"] = args.policy
                    r["moe_impl"] = args.moe_impl
                    results[key] = r
                    rl = r["roofline"]
                    print(f"         ok in {r['compile_s']}s  "
                          f"dominant={rl['dominant']} "
                          f"compute={rl['compute_s']:.3e}s "
                          f"memory={rl['memory_s']:.3e}s "
                          f"coll={rl['collective_s']:.3e}s "
                          f"useful={rl['useful_ratio']:.2f} "
                          f"peakGB={r['memory']['peak_bytes']/2**30:.2f} "
                          "(roofline seconds from H100 data-sheet rates)",
                          flush=True)
                    n_ok += 1
                # a cell's failure is recorded, with its trace, and the
                # honeylint: disable=no-bare-except -- exit code says so
                except Exception as e:
                    results[key] = {"arch": arch, "shape": shape,
                                    "status": "error",
                                    "error": f"{type(e).__name__}: {e}",
                                    "trace": traceback.format_exc()[-2000:]}
                    print(f"         FAILED: {type(e).__name__}: "
                          f"{str(e)[:300]}", flush=True)
                    n_fail += 1
            out_path.write_text(json.dumps(results, indent=1))
    print(f"done: {n_ok} ok, {n_skip} skip, {n_fail} fail "
          f"-> {out_path}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
