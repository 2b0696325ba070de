"""MVCC version management (paper Section 3.2).

Two shared 64-bit counters: the *global write version* (fetch-and-add by
writers) and the *global read version* (released in version order).  The
accelerator holds a copy of the read version, updated "over PCIe"; responses
to writes are delayed until that update completes — modeled by
``release()`` returning only after the device copy advances.

The release protocol supports multiple logical writers: a writer becomes
releasable when it is the writer with the smallest outstanding write
version; releases cascade in version order.
"""
from __future__ import annotations

import heapq


class VersionManager:
    def __init__(self, mvcc: bool = True):
        self.mvcc = mvcc
        self.global_write_version = 0
        self.global_read_version = 0
        # accelerator's copy, updated over "PCIe"
        self.device_read_version = 0
        self.device_updates = 0          # PCIe writes of the read version
        self._inflight: set[int] = set()  # acquired but unreleased versions
        self._done: list[int] = []        # finished, awaiting in-order release

    def acquire_write_version(self) -> int:
        """fetch_and_add on the global write version."""
        if not self.mvcc:
            return 0
        self.global_write_version += 1
        wv = self.global_write_version
        self._inflight.add(wv)
        return wv

    def release(self, wv: int):
        """Release changes to readers in version order (Section 3.2): set the
        global read version when this writer is the smallest outstanding one,
        then propagate to the accelerator copy."""
        if not self.mvcc:
            return
        self._inflight.discard(wv)
        heapq.heappush(self._done, wv)
        advanced = False
        while self._done and (not self._inflight
                              or self._done[0] < min(self._inflight)):
            self.global_read_version = heapq.heappop(self._done)
            advanced = True
        if advanced:
            # the PCIe update the paper waits on before acking the write
            self.device_read_version = self.global_read_version
            self.device_updates += 1

    def abort(self, wv: int):
        """A writer that restarts must still release its version number so
        later versions can be published."""
        self.release(wv)

    def read_version(self) -> int:
        """What the accelerator stamps onto incoming requests."""
        return self.device_read_version if self.mvcc else 0
