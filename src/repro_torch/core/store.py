"""HoneycombStore — the single-device facade (port of
``repro.core.store``).

``HoneycombStore`` is the paper's deployment: ONE ``StoreShard``
(core/shard.py) serving the whole keyspace behind the public
``put/get/scan/get_batch/scan_batch/export_snapshot`` facade, with its
snapshot on the GPU unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from .shard import StoreShard, SyncStats

__all__ = ["HoneycombStore", "StoreShard", "SyncStats"]


class HoneycombStore(StoreShard):
    """The paper's single-NIC deployment: one ``StoreShard`` owning the
    entire keyspace.  See core/shard.py for the snapshot/delta-sync
    semantics."""
