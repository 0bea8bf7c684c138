"""Slot schema — which feature slots exist, their types, and which are used.

Parity with the reference's DataFeedDesc slot list
(paddle/fluid/framework/data_feed.proto:17-38: name, type "uint64"/"float",
is_used, is_dense) and the derived all_slots_info_/used_slots_info_ tables the
readers build (data_feed.cc SlotPaddleBoxDataFeed::Init).

A sample line carries *all* slots in schema order; only ``used`` slots are
materialized into batches. ``dense`` float slots keep zero values (sparse
slots drop zeros / near-zeros at parse time).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass(frozen=True)
class SlotInfo:
    name: str
    type: str = "uint64"  # "uint64" | "float"
    used: bool = True
    dense: bool = False  # dense float slots keep zeros, have fixed dim
    dim: int = 1  # for dense float slots: expected width

    def __post_init__(self):
        if self.type not in ("uint64", "float"):
            raise ValueError(f"slot {self.name}: bad type {self.type}")


class SlotSchema:
    """Ordered slot list + derived index tables."""

    def __init__(
        self,
        slots: Sequence[SlotInfo],
        parse_ins_id: bool = False,
        parse_logkey: bool = False,
        label_slot: Optional[str] = None,
    ):
        self.slots: List[SlotInfo] = list(slots)
        self.parse_ins_id = parse_ins_id
        self.parse_logkey = parse_logkey
        self.label_slot = label_slot
        names = [s.name for s in self.slots]
        if len(set(names)) != len(names):
            raise ValueError("duplicate slot names")
        # used slots partitioned by type, preserving schema order
        self.used_sparse: List[SlotInfo] = [
            s for s in self.slots if s.used and s.type == "uint64"
        ]
        self.used_float: List[SlotInfo] = [
            s for s in self.slots if s.used and s.type == "float"
        ]
        self._sparse_idx = {s.name: i for i, s in enumerate(self.used_sparse)}
        self._float_idx = {s.name: i for i, s in enumerate(self.used_float)}
        if label_slot is not None and label_slot not in self._float_idx and label_slot not in self._sparse_idx:
            raise ValueError(f"label slot {label_slot} not a used slot")

    @property
    def num_sparse(self) -> int:
        return len(self.used_sparse)

    @property
    def num_float(self) -> int:
        return len(self.used_float)

    def sparse_slot_index(self, name: str) -> int:
        return self._sparse_idx[name]

    def float_slot_index(self, name: str) -> int:
        return self._float_idx[name]

    @staticmethod
    def ctr_schema(num_sparse: int, dense_dim: int = 13, with_label: bool = True) -> "SlotSchema":
        """Criteo-style convenience schema: label + dense floats + N sparse slots."""
        slots: List[SlotInfo] = []
        if with_label:
            slots.append(SlotInfo("label", type="float", dense=True, dim=1))
        if dense_dim:
            slots.append(SlotInfo("dense", type="float", dense=True, dim=dense_dim))
        for i in range(num_sparse):
            slots.append(SlotInfo(f"slot{i:03d}", type="uint64"))
        return SlotSchema(slots, label_slot="label" if with_label else None)
