"""Embedding-table placement across device shards.

The reference parallelizes embedding work across tables within one node
(SimpleParallelStrategy / PreallocationStrategy, SURVEY.md §2.2); the
multi-device analog is *model-parallel table sharding*: each device owns a
subset of whole tables, chosen by greedy balanced bin-packing on row counts
(rows ∝ device-memory bytes ∝ lookup bandwidth).  This module computes the static
placement plan; the collective lookup/update lives in
``parallel/embedding.py``.

Static-shape discipline (everything under jit must be uniform across
devices): every device gets exactly ``slots_per_shard`` table slots — unused
slots point at a reserved trash row — and every local stack is padded to the
same ``local_rows``.  Device-dependent slot metadata is passed into
``shard_map`` as sharded (N, K) arrays, never as per-device Python constants.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TablePlacement:
    """Static plan mapping tables -> (shard, slot) plus local row layout.

    Attributes:
      table_sizes: rows per table (global order).
      num_shards: number of devices along the table-sharding axis.
      slots_per_shard: K = max tables owned by any shard; all shards are
        padded to K slots.
      slot_tables: (N, K) global table index per slot (0 for padding slots —
        never dereferenced thanks to ``slot_valid``).
      slot_valid: (N, K) 1 for real slots, 0 for padding.
      slot_local_offsets: (N, K) row offset of each slot's table inside the
        shard's local stack; padding slots point at the trash row.
      local_rows: rows per local stack (max over shards, + 1 trash row).
      table_shard: (T,) owning shard per table.
      table_slot: (T,) slot index within the owning shard.
      table_local_offsets: (T,) local row offset of each table in its
        owner's stack.
    """

    table_sizes: Tuple[int, ...]
    num_shards: int
    slots_per_shard: int
    slot_tables: np.ndarray
    slot_valid: np.ndarray
    slot_local_offsets: np.ndarray
    local_rows: int
    table_shard: np.ndarray
    table_slot: np.ndarray
    table_local_offsets: np.ndarray
    # lane packing (ops/embedding.py rationale): PACK logical rows per
    # physical storage row; local stacks are (local_rows, D*pack) with
    # offsets above measured in PHYSICAL rows when pack > 1.
    pack: int = 1
    # Row-sharded tables (rows > max_rows_per_shard): every shard owns a
    # CONTIGUOUS block of ceil(rows/N) logical rows of each such table,
    # stored at the same local physical offset on every shard (the chunks
    # sit at the top of each local stack, before the slot tables).  These
    # tables are looked up with a masked local gather + reduce-scatter
    # instead of the slot all-to-all (parallel/embedding.py).
    row_sharded: Tuple[int, ...] = ()
    rs_rows_per_shard: Tuple[int, ...] = ()   # logical rows per shard block
    rs_local_offsets: Tuple[int, ...] = ()    # physical offset per rs table
    # Host-resident row-sharded tables (the CachedArrays-tier x sharding
    # composition): rs_host[k] marks row_sharded[k] as living in a SECOND
    # per-shard stack (N, host_local_rows, W) pinned to host memory;
    # rs_local_offsets[k] then indexes that stack.  host_local_rows
    # includes its own trailing trash row.
    rs_host: Tuple[bool, ...] = ()
    host_local_rows: int = 0
    # Column-sharded tables: every shard stores ALL rows but only
    # row_width/N of the feature lanes, as separate (N, R, W/N) param
    # leaves next to the slot/row-sharded stack (requires pack == 1 — the
    # natural regime is fs >= 128, e.g. MLPerf's D=128 tables).
    col_sharded: Tuple[int, ...] = ()

    @property
    def num_tables(self) -> int:
        return len(self.table_sizes)

    @property
    def trash_row(self) -> int:
        return self.local_rows - 1

    @property
    def host_row_sharded(self) -> Tuple[int, ...]:
        """Row-sharded tables whose blocks live in the host stack."""
        if not self.rs_host:
            return ()
        return tuple(t for k, t in enumerate(self.row_sharded)
                     if self.rs_host[k])

    @property
    def slot_table_list(self) -> Tuple[int, ...]:
        """Slot-placed (whole-table) tables, ascending global order."""
        return tuple(t for t in range(self.num_tables)
                     if t not in self.row_sharded
                     and t not in self.col_sharded)

    def out_column(self) -> np.ndarray:
        """(T_slot,) column of each slot table (in slot_table_list order)
        inside the (N*K)-wide exchanged layout (shard-major, slot-minor)."""
        return np.asarray(
            [self.table_shard[t] * self.slots_per_shard + self.table_slot[t]
             for t in self.slot_table_list], dtype=np.int32)

    def output_order(self) -> np.ndarray:
        """(T,) permutation restoring global table order from the
        [slot_table_list..., row_sharded..., col_sharded...] assembly
        order."""
        order = (list(self.slot_table_list) + list(self.row_sharded)
                 + list(self.col_sharded))
        inv = np.zeros(self.num_tables, dtype=np.int32)
        for pos, t in enumerate(order):
            inv[t] = pos
        return inv


def plan_placement(table_sizes: Sequence[int], num_shards: int,
                   pack: int = 1,
                   max_rows_per_shard: int = None,
                   col_sharded_tables: Sequence[int] = (),
                   host_tables: Sequence[int] = ()) -> TablePlacement:
    """Greedy balanced assignment: biggest table to the lightest shard.

    ``pack``: logical rows per physical storage row (config.pack); local
    offsets/row counts are then in physical rows and each table is padded
    to a whole number of physical rows.

    ``max_rows_per_shard``: tables with more rows are ROW-SHARDED — their
    rows split contiguously across all shards — instead of placed whole
    (required when one table exceeds a device's HBM, e.g. Criteo
    Terabyte's 292.8M-row table).  Default: no row sharding.
    """
    table_sizes = tuple(int(s) for s in table_sizes)
    phys_sizes = tuple(-(-s // pack) for s in table_sizes)
    t = len(table_sizes)

    # dedupe + validate the index lists up front: these come straight
    # from CLI strings, and an out-of-range host-table index used to be
    # silently ignored (the HBM offload the flag asked for never
    # happened), while a duplicate cs index built two full replicas
    col_sharded = tuple(sorted(set(int(x) for x in col_sharded_tables)))
    host_set = set(int(x) for x in host_tables)
    for name, idxs in (("col_sharded_tables", col_sharded),
                       ("host_tables", host_set)):
        bad = [x for x in idxs if not 0 <= x < t]
        if bad:
            raise ValueError(f"{name} indices {sorted(bad)} out of range "
                             f"for {t} tables")
    if col_sharded and pack != 1:
        raise ValueError(
            "column sharding requires pack == 1 (split lanes cannot be "
            "lane-packed); use feature_size >= 128 or packed_tables=False")
    if host_set & set(col_sharded):
        raise ValueError("a table cannot be both host-resident and "
                         "column-sharded")
    # host-resident tables are always row-sharded (each shard stores its
    # contiguous block in ITS host memory) regardless of max_rows_per_shard
    row_sharded = tuple(
        ti for ti in range(t)
        if ti in host_set
        or (max_rows_per_shard is not None
            and table_sizes[ti] > max_rows_per_shard
            and ti not in col_sharded))
    slot_set = [ti for ti in range(t)
                if ti not in row_sharded and ti not in col_sharded]
    # row-sharded blocks: whole physical rows per shard, fixed local offsets
    def _rs_rows(rows: int) -> int:
        chunk = -(-rows // num_shards)       # ceil rows / shards
        return pack * (-(-chunk // pack))    # round up to whole phys rows

    rs_rows_per_shard = tuple(_rs_rows(table_sizes[ti])
                              for ti in row_sharded)
    rs_phys_per_shard = tuple(r // pack for r in rs_rows_per_shard)
    rs_host = tuple(ti in host_set for ti in row_sharded)
    rs_local_offsets = []
    off = 0        # device-stack rs region
    host_off = 0   # host-stack rs region
    for p, is_host in zip(rs_phys_per_shard, rs_host):
        if is_host:
            rs_local_offsets.append(host_off)
            host_off += p
        else:
            rs_local_offsets.append(off)
            off += p
    rs_total_phys = off
    host_local_rows = host_off + 1 if host_off else 0  # + trash row

    order = [ti for ti in np.argsort(-np.asarray(table_sizes),
                                     kind="stable") if ti in slot_set]
    loads = np.zeros(num_shards, dtype=np.int64)
    counts = np.zeros(num_shards, dtype=np.int64)
    table_shard = np.zeros(t, dtype=np.int32)
    n_slot = len(slot_set)
    k = -(-n_slot // num_shards) if n_slot else 1  # ceil; >=1 non-empty
    for ti in order:
        # lightest shard with a free slot
        candidates = np.flatnonzero(counts < k)
        d = candidates[np.argmin(loads[candidates])]
        table_shard[ti] = d
        loads[d] += table_sizes[ti]
        counts[d] += 1

    slot_tables = np.zeros((num_shards, k), dtype=np.int32)
    slot_valid = np.zeros((num_shards, k), dtype=np.int32)
    slot_local_offsets = np.zeros((num_shards, k), dtype=np.int32)
    table_slot = np.zeros(t, dtype=np.int32)
    table_local_offsets = np.zeros(t, dtype=np.int32)
    max_rows = 0
    for d in range(num_shards):
        tables = [ti for ti in slot_set if table_shard[ti] == d]
        # slot tables live ABOVE the row-sharded blocks (fixed offsets)
        off = rs_total_phys
        for s, ti in enumerate(tables):
            slot_tables[d, s] = ti
            slot_valid[d, s] = 1
            slot_local_offsets[d, s] = off
            table_slot[ti] = s
            table_local_offsets[ti] = off
            off += phys_sizes[ti]
        max_rows = max(max_rows, off)
    for ti in (*row_sharded, *col_sharded):  # sentinels; resolved elsewhere
        table_shard[ti] = -1
        table_slot[ti] = -1
        table_local_offsets[ti] = -1
    local_rows = max_rows + 1  # + trash row for padding slots
    # padding slots all target the trash row; any id lands inside the stack
    # only if the id is 0 (ids for padding slots are zeroed in the kernel).
    for d in range(num_shards):
        for s in range(k):
            if not slot_valid[d, s]:
                slot_local_offsets[d, s] = local_rows - 1

    return TablePlacement(
        table_sizes=table_sizes,
        num_shards=num_shards,
        slots_per_shard=k,
        slot_tables=slot_tables,
        slot_valid=slot_valid,
        slot_local_offsets=slot_local_offsets,
        local_rows=local_rows,
        table_shard=table_shard,
        table_slot=table_slot,
        table_local_offsets=table_local_offsets,
        pack=pack,
        row_sharded=row_sharded,
        rs_rows_per_shard=rs_rows_per_shard,
        rs_local_offsets=tuple(rs_local_offsets),
        col_sharded=col_sharded,
        rs_host=rs_host,
        host_local_rows=host_local_rows,
    )
