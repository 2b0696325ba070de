"""LID -> physical slot page table with host and accelerator copies.

The paper (Sections 2, 3.4, 5) keeps the page table in host DRAM and a copy
in FPGA on-board DRAM; the CPU updates the host copy and issues a PCIe
command to update the accelerator copy.  We keep the host copy in numpy and
model the accelerator copy as a *pending update queue*: updates are applied
to the device image at the next snapshot export, and the number of sync
commands is counted (it is the paper's key PCIe-traffic metric — log blocks
exist precisely to amortize it, one sync per merge instead of per write).
"""
from __future__ import annotations

import numpy as np

NULL = -1


class PageTable:
    def __init__(self, capacity: int = 1024):
        self.host = np.full(capacity, NULL, np.int32)
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        self.pending: dict[int, int] = {}   # LID -> phys, not yet on device
        self.sync_commands = 0              # paper: PCIe page-table updates
        self.device_image = self.host.copy()
        # bumped on growth: a resident device table has the old shape and
        # must be republished in full
        self.generation = 0
        # remap observer (paper Section 5: a page-table command for a LID
        # invalidates that LID's interior-cache entry); the owning shard
        # wires this to InteriorCache.invalidate
        self.on_remap = None

    def _grow(self):
        cap = len(self.host)
        self.host = np.concatenate([self.host, np.full(cap, NULL, np.int32)])
        self.device_image = np.concatenate(
            [self.device_image, np.full(cap, NULL, np.int32)])
        self._free.extend(range(2 * cap - 1, cap - 1, -1))
        self.generation += 1

    def alloc_lid(self, phys: int) -> int:
        if not self._free:
            self._grow()
        lid = self._free.pop()
        self.host[lid] = phys
        self.pending[lid] = phys
        self.sync_commands += 1
        return lid

    def remap(self, lid: int, phys: int):
        """Atomic subtree swap (paper Fig. 3c / 4c): one mapping change makes
        a whole new buffer (or subtree) visible."""
        self.host[lid] = phys
        self.pending[lid] = phys
        self.sync_commands += 1
        if self.on_remap is not None:
            self.on_remap(lid)

    def free_lid(self, lid: int):
        self.host[lid] = NULL
        self.pending[lid] = NULL
        self._free.append(lid)
        if self.on_remap is not None:
            self.on_remap(lid)

    def lookup(self, lid: int) -> int:
        return int(self.host[lid])

    def take_pending(self) -> tuple[np.ndarray, np.ndarray]:
        """Drain the pending update queue as (lids, phys) command arrays —
        the batched PCIe page-table commands of one sync — applying them to
        the device image."""
        lids = np.fromiter(self.pending.keys(), np.int32, len(self.pending))
        phys = np.fromiter(self.pending.values(), np.int32, len(self.pending))
        self.device_image[lids] = phys
        self.pending.clear()
        return lids, phys

    def flush_to_device(self) -> np.ndarray:
        """Apply pending updates to the accelerator image (the 'PCIe
        commands' batch) and return it."""
        self.take_pending()
        return self.device_image

    @property
    def n_live(self) -> int:
        return int((self.host != NULL).sum())
