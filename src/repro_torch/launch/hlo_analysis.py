"""Roofline accounting over a traced call (port of
``repro.launch.hlo_analysis``).

Nothing here reads HLO.  The reference compiles a step and reads XLA's
``cost_analysis()``, ``memory_analysis()`` and the collectives of the
compiled HLO text.  The port runs the step once, eagerly, and counts at
PyTorch's dispatcher while it runs: under ``FakeTensorMode`` and a fake
process group in the dry run (``launch/dryrun.py``), so that nothing is
allocated and nothing is sent, or on real tensors.  ``StepCounter`` is one
``TorchDispatchMode`` that keeps three tallies for one rank:

* **collectives**, the reference's ``collective_bytes`` layout
  (``{"bytes": {...}, "counts": {...}, "total_bytes": n}``) over its five
  kinds.  It sees the ``_c10d_functional`` ops that DTensor's
  ``redistribute`` and ``full_tensor`` issue and the ``c10d`` ops of
  ``compat.psum`` (``all_reduce``) and ``compat.ppermute`` (a ``send``
  and a ``recv`` a pair).  It meters RESULT bytes, as the reference
  does: the reduced tensor of an all-reduce, the gathered tensor of an
  all-gather, the scattered shard of a reduce-scatter, the received
  tensor of an all-to-all and of a permute (a ``recv``; a ``send`` is
  that receive's other half and is not counted).  ``wait_tensor`` is not
  counted, as the reference skips ``-done``.  A collective it cannot
  file under the five kinds raises.  The counts do not equal XLA's:
  GSPMD's partitioner places its own collectives, where the port's
  ``build_step`` gathers each weight whole at its use.  On a CPU mesh
  DTensor turns a shard-to-shard redistribute into an all-gather and a
  chunk (gloo has no all-to-all), where a CUDA mesh issues an all-to-all.
* **cost**, standing for ``compiled.cost_analysis()``: ``"flops"`` from
  ``torch.utils.flop_counter.FlopCounterMode`` (entered beside this
  counter by ``trace``), which counts matrix products, convolutions and
  attention only, where XLA also counts elementwise work; and
  ``"bytes accessed"``, the sum over every aten op dispatched of its
  input and output tensors' bytes (each distinct tensor of an op once as
  an input and once as an output), views and metadata-only ops
  (``_NO_ACCESS``, and the ``prim`` queries a fake tensor answers through
  the dispatcher) left out: what an eager step reads and writes at most,
  with no fusion.
* **memory**, standing for ``memory_analysis()``, one rank's:
  ``argument_bytes`` and ``output_bytes`` are the local bytes of the
  arguments and of the outputs (a DTensor's local block), each storage
  once; ``alias_bytes`` the bytes of outputs that are donated arguments
  updated in place; ``temp_bytes`` the peak, over the call, of the live
  bytes of the storages it allocated that are not among its outputs
  (XLA's temporaries).  A storage is live from the op that first returns
  it to the death of the last tensor over it that the counter saw (a
  ``weakref.finalize`` each).  ``peak_bytes`` is the reference's
  arithmetic, argument + output + temp - alias.

The roofline's constants are the H100 SXM data sheet's, not measured
speeds: a figure derived from them is a bound, and says so.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12   # H100 SXM data sheet: dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12      # H100 SXM data sheet: HBM3 bytes/s
LINK_BW = 450e9       # H100 SXM data sheet: NVLink bytes/s each way
                      # (the reference's ICI_BW: one chip's link payload)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name fragments -> the reference's kinds; order matters ("all_gather"
# before "gather", "reduce_scatter" before "reduce")
_KINDS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("recv", "collective-permute"))
_NOT_COUNTED = ("wait_tensor", "send", "barrier", "monitored_barrier",
                "_wrap_tensor_autograd")
_COLLECTIVE_NS = ("c10d", "_c10d_functional", "_c10d_functional_autograd",
                  "c10d_functional")

# dispatched ops that read and write no tensor data
_NO_ACCESS = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "detach", "alias", "lift_fresh",
              "set_", "resize_", "sym_size", "sym_stride", "sym_numel",
              "sym_storage_offset", "is_same_size", "wait_tensor"}


def _tensors(x, out: dict) -> dict:
    """The distinct tensors (by id) of nested lists, tuples and dicts."""
    if isinstance(x, torch.Tensor):
        out.setdefault(id(x), x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_kind(func) -> str | None:
    """The reference's kind of a dispatched collective, None for an op
    that is not one or is not counted (``wait_tensor``, ``send``,
    barriers).  Raises on a collective outside the five kinds."""
    if func.namespace not in _COLLECTIVE_NS:
        return None
    name = func._opname
    if any(name.startswith(n) or name == n + "_" for n in _NOT_COUNTED):
        return None
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    raise ValueError(f"{func}: a collective outside the reference's five "
                     f"kinds {COLLECTIVES}")


def _result(func, args, out) -> dict:
    """The result tensors of a collective: the returned tensor of a
    ``_c10d_functional`` op, the tensors of the first argument (the
    output list, updated in place) of a ``c10d`` op."""
    if func.namespace == "c10d":
        return _tensors(args[0], {})
    return _tensors(out, {})


def _local(x):
    """A DTensor's local block, any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _leaves(tree) -> list:
    """Every tensor leaf of nested dicts, tuples (named or not) and lists,
    DTensors as their local blocks."""
    if isinstance(tree, torch.Tensor):
        return [_local(tree)]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _storage_bytes(leaves) -> dict:
    """{storage key: its bytes} of tensors, each storage once."""
    return {_storage_key(t): t.untyped_storage().nbytes() for t in leaves}


class StepCounter(TorchDispatchMode):
    """Counts the collectives, the bytes accessed and the live bytes of
    the aten ops dispatched while it is entered (see the module
    docstring).  ``args`` are the call's arguments: their storages are
    not the call's allocations.  Lets DTensor turn its ops into local ops
    and collectives first (``NotImplemented`` for a DTensor), as
    ``CommDebugMode`` does, and counts those."""

    def __init__(self, args=()):
        super().__init__()
        self.paused = False
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.bytes_accessed = 0
        self._args = set(_storage_bytes(_leaves(args)))
        # storage key -> [bytes, tensors seen, birth]; a key (the storage's
        # address) may come back after a free, a birth never does
        self._live: dict[int, list] = {}
        self._events: list[tuple] = []      # (birth, +bytes / -bytes)

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._events.append((entry[2], -entry[0]))
            del self._live[key]

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._args:
            return
        entry = self._live.get(key)
        if entry is None:
            nb = t.untyped_storage().nbytes()
            entry = self._live[key] = [nb, 0, len(self._events)]
            self._events.append((entry[2], nb))
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused or func.namespace == "prim":   # see ``trace``; a
            return out                   # fake tensor's metadata queries
        kind = collective_kind(func)
        if kind is not None:
            self.coll_counts[kind] += 1
            self.coll_bytes[kind] += sum(
                _nbytes(t) for t in _result(func, args, out).values())
        name = func._opname
        outs = _tensors(out, {})
        if not (func.is_view or name in _NO_ACCESS):
            ins = _tensors(args, _tensors(kwargs, {}))
            self.bytes_accessed += sum(_nbytes(t) for t in ins.values()) \
                + sum(_nbytes(t) for t in outs.values())
        for t in outs.values():
            self._track(t)
        return out

    def collectives(self) -> dict:
        return {"bytes": dict(self.coll_bytes),
                "counts": dict(self.coll_counts),
                "total_bytes": sum(self.coll_bytes.values())}

    def memory(self, args, out, donate_argnums=()) -> dict:
        """One rank's memory figures for a call of ``args`` that returned
        ``out`` (see the module docstring)."""
        arg = _storage_bytes(_leaves(args))
        res = _storage_bytes(_leaves(out))
        donated = set(_storage_bytes(_leaves(
            [args[i] for i in donate_argnums])))
        alias = sum(b for k, b in res.items() if k in donated)
        argument, output = sum(arg.values()), sum(res.values())
        outs = {self._live[k][2] for k in res if k in self._live}
        live = temp = 0
        for birth, nb in self._events:   # the outputs' storages left out
            if birth not in outs:
                live += nb
                temp = max(temp, live)
        return {"argument_bytes": argument, "output_bytes": output,
                "temp_bytes": temp, "alias_bytes": alias,
                "peak_bytes": argument + output + temp - alias}


class _Paused:
    """A context that pauses a ``StepCounter`` inside another context."""

    def __init__(self, counter: StepCounter, inner=None):
        self.counter, self.inner = counter, inner

    def __enter__(self):
        if self.inner is not None:
            self.inner.__enter__()
        self.counter.paused = True

    def __exit__(self, *exc):
        self.counter.paused = False
        if self.inner is not None:
            return self.inner.__exit__(*exc)
        return False


@dataclasses.dataclass
class Trace:
    """What ``trace`` counted over one call."""
    cost: dict          # {"flops", "bytes accessed"}
    collectives: dict   # collective_bytes' layout
    memory: dict        # argument/output/temp/alias/peak bytes


def trace(fn, args: tuple, donate_argnums=()) -> Trace:
    """Call ``fn(*args)`` once under ``FlopCounterMode`` and a
    ``StepCounter`` and return what they counted for this rank."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils.flop_counter import FlopCounterMode
    flops = FlopCounterMode(display=False)
    counter = StepCounter(args)
    # DTensor infers an op's output shape by running the op on fake
    # tensors, under the fake mode already active if there is one: the
    # dry run's, whose ops would reach the counter.  Its hook around that
    # inference (a lock, a null context by default) pauses the counter.
    lock = ShardingPropagator.__dict__.get("_fake_mode_lock")
    ShardingPropagator._fake_mode_lock = _Paused(counter, lock)
    try:
        with flops, counter:
            out = fn(*args)
    finally:
        if lock is None:
            del ShardingPropagator._fake_mode_lock
        else:
            ShardingPropagator._fake_mode_lock = lock
    return Trace(cost={"flops": float(flops.get_total_flops()),
                       "bytes accessed": float(counter.bytes_accessed)},
                 collectives=counter.collectives(),
                 memory=counter.memory(args, out, donate_argnums))


def collective_bytes(fn, *args, **kwargs) -> dict:
    """Per-kind result bytes and op counts of the collectives one call of
    ``fn`` issues on this rank (the reference's layout; the reference
    parses them out of HLO text)."""
    counter = StepCounter()
    with counter:
        fn(*args, **kwargs)
    return counter.collectives()


@dataclasses.dataclass
class Roofline:
    flops: float                # per device
    hbm_bytes: float            # per device
    coll_bytes: float           # per device
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float          # per device ("useful" flops)
    useful_ratio: float

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline(cost: dict, coll: dict, model_flops_per_device: float
             ) -> Roofline:
    """The three terms of one device's step: FLOPs over ``PEAK_FLOPS``,
    bytes accessed over ``HBM_BW``, collective bytes over ``LINK_BW``
    (data-sheet bounds, not measured times)."""
    if isinstance(cost, (list, tuple)):   # the reference's older list form
        cost = cost[0] if cost else {}
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    cb = float(coll["total_bytes"])
    terms = {"compute": flops / PEAK_FLOPS,
             "memory": hbm / HBM_BW,
             "collective": cb / LINK_BW}
    dominant = max(terms, key=terms.get)
    return Roofline(
        flops=flops, hbm_bytes=hbm, coll_bytes=cb,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"], dominant=dominant,
        model_flops=model_flops_per_device,
        useful_ratio=(model_flops_per_device / flops) if flops else 0.0)


def model_flops_per_step(cfg, shape) -> float:
    """6*N*D train / 2*N*D forward, N = active params (global, whole
    step)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch      # decode: one token/seq
