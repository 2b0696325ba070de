"""Fault-tolerant checkpointing (port of ``repro.train.checkpoint``, with
its on-disk format, so that checkpoints interchange both ways).

  * atomic:    leaves written to ``step_%010d.tmp``, the manifest last,
               then one rename publishes the checkpoint: a writer that
               died leaves no half-readable state.
  * async:     the device -> host copy happens on the caller's thread
               (into fresh host tensors, so the next in-place step cannot
               reach them); serialization runs on a worker thread, so the
               train loop overlaps step N+1 with persisting step N.
  * format:    ``leaf_%05d.npy`` per leaf in ``jax.tree.flatten``'s order
               (``schema.flatten``: dict keys sorted, then ``OptState`` as
               step, mu, nu) and ``manifest.json`` with each leaf's shape
               and dtype name; bf16 is saved as its uint16 bit pattern
               with the tag ``"bfloat16"``.  ``restore`` reads shapes and
               dtypes from the manifest and the structure from
               ``like_tree``; the manifest's ``treedef`` is a description
               for people, written by each package in its own words.
  * catalog:   every checkpoint registers into a Honeycomb ordered store
               (the port's ``HoneycombStore``, step -> path); "resume from
               the newest checkpoint <= S" is a floor SCAN, the paper's
               own lookup.  Only the store's host operations are used.
  * retention: keep the newest ``keep`` checkpoints, delete older ones
               (and their catalog entries) after a successful publish.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from ..core import HoneycombConfig, HoneycombStore
from ..core.keys import int_key
from ..models import schema as sc


def _to_host(x) -> np.ndarray:
    """A leaf as a numpy array of its own (bf16 as its uint16 bits)."""
    t = torch.as_tensor(x).detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy() \
            .view(np.uint16)
    return t.to("cpu", copy=True).numpy()


def _dtype_name(x) -> str:
    t = torch.as_tensor(x)
    return "bfloat16" if t.dtype == torch.bfloat16 \
        else str(t.dtype).removeprefix("torch.")


def _from_savable(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _describe(tree) -> str:
    """The tree's structure, leaves as ``*`` (the manifest's treedef)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={_describe(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(map(_describe, tree)) + ")"
    return "None" if tree is None else "*"


class CheckpointManager:
    def __init__(self, root: str | Path, keep: int = 3,
                 catalog: HoneycombStore | None = None,
                 device: str | torch.device = "cuda"):
        """``device`` is where ``restore`` places leaves and where the
        catalog store lives (it raises without a card when "cuda")."""
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.device = torch.device(device)
        self.catalog = catalog or HoneycombStore(
            HoneycombConfig(node_cap=32, log_cap=8, n_shortcuts=4),
            device=self.device)
        self._worker: threading.Thread | None = None
        self._load_existing()

    def _load_existing(self):
        for d in sorted(self.root.glob("step_*")):
            if (d / "manifest.json").exists():
                step = int(d.name.split("_")[1])
                self.catalog.put(int_key(step), str(d).encode())

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, blocking: bool = True,
             extra: dict | None = None) -> Path:
        """Checkpoint a tree.  With ``blocking=False`` the device -> host
        copy happens now and serialization on a worker thread."""
        leaves = sc.flatten(tree)
        host = [(_to_host(x), _dtype_name(x)) for x in leaves]
        treedef = _describe(tree)
        final = self.root / f"step_{step:010d}"

        def work():
            tmp = final.with_suffix(".tmp")
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            shapes = []
            for i, (a, dtype) in enumerate(host):
                np.save(tmp / f"leaf_{i:05d}.npy", a)
                shapes.append([list(a.shape), dtype])
            manifest = {"step": step, "n_leaves": len(host),
                        "shapes": shapes, "treedef": treedef,
                        "extra": extra or {}}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)                      # atomic publish
            self.catalog.put(int_key(step), str(final).encode())
            self._retain()

        if blocking:
            work()
        else:
            self.wait()
            self._worker = threading.Thread(target=work, daemon=True)
            self._worker.start()
        return final

    def wait(self):
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def _retain(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            d = self.root / f"step_{s:010d}"
            if d.exists():
                shutil.rmtree(d)
            self.catalog.delete(int_key(s))

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        items = self.catalog.scan(int_key(0), int_key(2 ** 62))
        return [int.from_bytes(k, "big") for k, _ in items]

    def latest_step(self, at_or_before: int | None = None) -> int | None:
        """Floor lookup through the Honeycomb catalog (SCAN semantics)."""
        if at_or_before is None:
            steps = self.all_steps()
            return steps[-1] if steps else None
        hit = self.catalog.scan(int_key(at_or_before), int_key(at_or_before))
        return int.from_bytes(hit[0][0], "big") if hit else None

    def restore(self, step: int, like_tree, device=None):
        """Load a checkpoint into the structure of ``like_tree``, each leaf
        a tensor of its saved dtype on ``device`` (the manager's when
        None).  Returns (tree, manifest)."""
        device = self.device if device is None else torch.device(device)
        d = self.root / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = [_from_savable(np.load(d / f"leaf_{i:05d}.npy"),
                                manifest["shapes"][i][1], device)
                  for i in range(manifest["n_leaves"])]
        return sc.unflatten(like_tree, leaves), manifest
