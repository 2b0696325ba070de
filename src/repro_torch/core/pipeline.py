"""Epoch-pipeline stage meters (port of ``repro.core.pipeline``).

Each ``StoreShard`` keeps an *active* snapshot that read batches execute
against and stages the next epoch into a *standby* (``begin_export``);
``flip`` publishes the standby atomically.  ``PipelineStats`` meters the
shard's staging/flip side and the device-lane occupancy of its read
batches, and the scheduler's admit/export/dispatch stages
(core/scheduler.py, ``"serial"`` or ``"pipelined"``).
"""
from __future__ import annotations

import dataclasses

from .telemetry import samples_from

PIPELINE_MODES = ("serial", "pipelined")


@dataclasses.dataclass
class PipelineStats:
    """Per-stage timing/occupancy meters for the epoch pipeline."""
    runs: int = 0               # scheduler run() epochs completed
    admit_s: float = 0.0        # host write-apply stage wall time
    export_s: float = 0.0       # standby staging wall time (host side)
    dispatch_s: float = 0.0     # read-batch dispatch stage wall time
    sync_stall_s: float = 0.0   # time blocked on sync completion before
    #   any read of the epoch could dispatch (serial barrier; ~0 pipelined)
    staged_exports: int = 0     # begin_export calls that staged a standby
    flips: int = 0              # epoch publishes
    dispatched_lanes: int = 0   # real requests inside device batches
    padded_lanes: int = 0       # bucket_pow2 device lanes those occupied

    def merge(self, other: "PipelineStats"):
        """Accumulate another meter (aggregation over shards)."""
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))

    @property
    def lane_occupancy(self) -> float:
        """Real requests / padded device lanes (1.0 = no padding waste)."""
        return (self.dispatched_lanes / self.padded_lanes
                if self.padded_lanes else 0.0)

    @property
    def stall_fraction(self) -> float:
        """sync_stall_s over total staged wall time."""
        busy = self.admit_s + self.export_s + self.dispatch_s
        return self.sync_stall_s / busy if busy > 0 else 0.0

    def collect(self):
        """Registry samples: ``pipeline_*`` counters plus the two
        derived-ratio gauges."""
        return samples_from(self, "pipeline", "pipeline",
                            derived=("lane_occupancy", "stall_fraction"))
