"""Compiler-measured communication audit for the sharded train step.

The per-step collective traffic of the sharded train step can be counted
exactly without the cards: XLA's SPMD partitioner emits the same
collective ops on the N-device virtual CPU mesh as on N GPUs, so this
tool lowers the production hybrid step for several mesh sizes, parses
every collective out of the optimized HLO, and reports

  * the collective inventory (op kind, dtype/shape, bytes), and
  * estimated per-device link traffic per step (standard ring/edge
    cost model: all-gather / reduce-scatter / all-to-all move
    (N-1)/N x payload per device; all-reduce ~ 2 x (N-1)/N).

The byte counts are facts of the program; times and scaling efficiency
come only from runs on the cards.

Collective volumes for DLRM depend on (batch/chip, feature size, table
count), not table rows, so the audit uses scaled-down rows (CPU-memory
friendly) with the production batch, feature size, and MLP shapes.

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
      python scaling_audit.py [--batch-per-chip 4096] [--mesh 2 4 8]
"""

from __future__ import annotations

import argparse
import functools
import re
import sys
from collections import defaultdict

import numpy as np

DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
               "s64": 8, "u64": 8, "f64": 8, "pred": 1, "s8": 1, "u8": 1,
               "s16": 2, "u16": 2}

COLLECTIVES = ("all-to-all", "all-gather", "all-reduce", "reduce-scatter",
               "collective-permute")

AUDIT_ROWS = 4000  # scaled-down rows; volumes don't depend on rows


def _shape_bytes(type_str: str) -> int:
    """Bytes of an HLO type string like 'f32[8,4096,16]' or a tuple
    '(f32[8], f32[8,16])'."""
    total = 0
    for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", type_str):
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def _parse_groups(line: str):
    """Replica groups of one collective: list of device-id lists, or None
    when absent.  Handles the explicit ``{{0,1},{2,3}}`` form and the v2
    iota form ``[n,m]`` / ``[n,m]<=[d0,d1]T(p0,p1)`` (device ids = iota
    over the ``<=`` dims, transposed by T, reshaped (n, m) — XLA may
    print strided groups this way, so decoding it wrong would silently
    misclassify DCN traffic as ICI)."""
    m = re.search(r"replica_groups=(\{\{[^}]*\}(?:,\{[^}]*\})*\}"
                  r"|\[[\d,]*\](?:<=\[[\d,]*\](?:T\([\d,]*\))?)?)", line)
    if not m:
        return None
    s = m.group(1)
    if s.startswith("["):
        head = re.match(r"\[([\d,]*)\]", s)
        n, sz = (int(x) for x in head.group(1).split(","))
        suffix = s[head.end():]
        ids = np.arange(n * sz)
        if suffix:
            sm = re.match(r"<=\[([\d,]*)\](?:T\(([\d,]*)\))?", suffix)
            dims = [int(x) for x in sm.group(1).split(",")]
            ids = ids.reshape(dims)
            if sm.group(2):
                perm = [int(x) for x in sm.group(2).split(",")]
                ids = ids.transpose(perm)
        return [list(map(int, g)) for g in ids.reshape(n, sz)]
    return [[int(x) for x in g.split(",") if x]
            for g in re.findall(r"\{([\d,]*)\}", s[1:-1])]


def _group_axis(groups, ici: int) -> str:
    """'ici' when every group stays within one ICI row of a (dcn, ici)
    device grid, 'dcn' when every group spans rows at a fixed ICI
    column, 'mesh' otherwise (e.g. a hierarchical whole-mesh reduce)."""
    axes = set()
    for g in groups:
        if len(g) <= 1:
            continue
        rows = {d // ici for d in g}
        cols = {d % ici for d in g}
        if len(rows) == 1:
            axes.add("ici")
        elif len(cols) == 1:
            axes.add("dcn")
        else:
            axes.add("mesh")
    return axes.pop() if len(axes) == 1 else "mesh"


def _sub4_savings_bytes(type_str: str, wire_dtypes) -> int:
    """Result bytes a 4-byte wire would ADD over this type's elements of
    the given wire dtypes: sum of n_elems * (4 - itemsize)."""
    total = 0
    for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", type_str):
        if dt not in wire_dtypes or DTYPE_BYTES[dt] >= 4:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * (4 - DTYPE_BYTES[dt])
    return total


def collect_collectives(hlo_text: str, ici: int = None,
                        with_sub4=()):
    """[(kind, result_bytes, group_size, axis)] for every collective in
    the HLO (fusion-proof: collectives are never fused into other ops).
    ``axis`` classifies which mesh axis the op rides when ``ici`` (the
    ICI-axis length of a (dcn, ici) grid) is given.  ``with_sub4`` (a
    tuple of wire dtype names) appends each op's
    :func:`_sub4_savings_bytes` (for :func:`exchange_savings`)."""
    unknown = re.findall(r"\b(ragged-all-to-all|collective-broadcast"
                         r"|all-to-all-start)\b", hlo_text)
    if unknown:
        raise NotImplementedError(
            f"HLO contains unmodeled collectives {sorted(set(unknown))}; "
            "extend scaling_audit before trusting its totals")
    out = []
    for m in re.finditer(
            r"=\s+((?:\([^)]*\)|\S+))\s+(%?)("
            + "|".join(COLLECTIVES) + r")(-start|-done)?(\.\d+)?\(([^\n]*)",
            hlo_text):
        type_str, kind, async_part, line = (m.group(1), m.group(3),
                                            m.group(4), m.group(6))
        if async_part == "-done":
            continue  # async pair: counted once, at the matching -start
        groups = _parse_groups(line)
        gsz = max(len(g) for g in groups) if groups else 0
        axis = _group_axis(groups, ici) if (groups and ici) else "-"
        row = (kind, _shape_bytes(type_str), gsz, axis)
        if with_sub4:
            row += (_sub4_savings_bytes(type_str, with_sub4),)
        out.append(row)
    return out


def exchange_savings(pre_hlo: str, ici: int = None,
                     wire_dtypes=("bf16",)):
    """Per-chip link bytes saved by sub-f32 explicit exchanges, keyed by
    mesh axis ('-' when ``ici`` is None).

    Measured from the PRE-optimization HLO, where the shard_map
    collectives carry the program's wire dtype: the CPU backend then
    widens sub-f32 collectives back to f32 (verified: even a native-bf16
    all_to_all compiles to an f32 exchange on CPU), so the post-opt
    inventory over-counts exactly this amount relative to the GPU
    backend, which transmits bf16 natively.

    ``wire_dtypes`` limits the credit to the dtypes the exchange
    compression actually emits — a pred/s8 collective some future change
    introduces must NOT be booked as bf16-exchange savings (it would
    exist identically in the f32 baseline)."""
    saved = defaultdict(float)
    for kind, rb, gsz, axis, sub4 in collect_collectives(
            pre_hlo, ici=ici, with_sub4=wire_dtypes):
        if sub4:
            if not gsz:
                # replica groups failed to parse: a silent 0-byte credit
                # would under-report the wire win with no trace — the
                # same no-silent-caps rule the unknown-collective guard
                # enforces
                raise NotImplementedError(
                    f"sub-f32 {kind} with unparsed replica_groups in the "
                    "pre-optimization HLO; extend _parse_groups")
            saved[axis] += link_bytes(kind, sub4, gsz)
    return dict(saved)


def link_bytes(kind: str, result_bytes: int, n: int) -> float:
    """Per-device link traffic for one collective (ring/edge cost model).

    all-gather: result is the FULL gathered buffer; each chip receives
    (n-1)/n of it.  reduce-scatter: result is the 1/n shard; each chip
    sends/receives (n-1)x the shard.  all-reduce = reduce-scatter +
    all-gather over the full buffer: 2(n-1)/n x result.  all-to-all:
    result is this chip's post-exchange buffer; (n-1)/n of it crossed a
    link.  collective-permute: the whole result crossed one link."""
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-reduce":
        return 2 * result_bytes * (n - 1) / n
    if kind == "all-to-all":
        return result_bytes * (n - 1) / n
    return float(result_bytes)  # collective-permute


def _lower_step_hlo(mesh, placement, batch_per_chip: int,
                    feature_size: int, exchange_dtype=None):
    """Build the production-shaped model on ``mesh``/``placement``, lower
    one hybrid train step, and return ``(pre_hlo, optimized_hlo)`` text.

    ``pre_hlo`` (the pre-optimization HLO, which keeps the program's
    wire dtypes on the explicit shard_map collectives — the CPU
    backend's pipeline widens sub-f32 collectives to f32, see
    exchange_savings) is only generated when ``exchange_dtype`` is set;
    it is None otherwise.

    Production MLP shapes + feature size + 26 tables; scaled-down rows
    (collective volumes don't depend on rows — see module docstring)."""
    import jax
    import jax.numpy as jnp
    import dlrm_tpu
    from dlrm_tpu.parallel import embedding as pemb
    from dlrm_tpu.parallel.mesh import batch_sharding, param_shardings
    from dlrm_tpu.train.train import sharded_train_step

    config = dlrm_tpu.DLRMConfig(
        bottom_mlp_sizes=(13, 512, 256, feature_size),
        top_mlp_sizes=(1024, 1024, 512, 256, 1),
        feature_size=feature_size,
        table_sizes=(AUDIT_ROWS,) * 26,
        small_table_threshold=0,  # production deep tables: gather path
        exchange_dtype=exchange_dtype,
    )
    params = dlrm_tpu.init_params(jax.random.key(0), config)
    sh = {"bottom": params["bottom"],
          "emb": pemb.shard_tables(params["emb"], placement, config),
          "top": params["top"]}
    sh = jax.device_put(sh, param_shardings(mesh, sh))
    b = batch_per_chip * mesh.devices.size
    rng = np.random.default_rng(0)
    bs = batch_sharding(mesh)
    dense = jax.device_put(jnp.asarray(
        rng.normal(size=(b, 13)).astype(np.float32)), bs)
    sparse = jax.device_put(jnp.asarray(np.stack(
        [rng.integers(0, s, size=b) for s in config.table_sizes],
        axis=1).astype(np.int32)), bs)
    labels = jax.device_put(jnp.asarray(
        (rng.random(b) > 0.5).astype(np.float32)), bs)
    step = functools.partial(sharded_train_step, config=config, lr=0.1,
                             mesh=mesh, placement=placement, axis="d")
    lowered = jax.jit(step).lower(sh, dense, sparse, labels)
    pre = (lowered.compiler_ir(dialect="hlo").as_hlo_text()
           if exchange_dtype is not None else None)
    return pre, lowered.compile().as_text()


def audit(n_devices: int, batch_per_chip: int, feature_size: int = 16,
          row_shard: bool = False, exchange_dtype=None):
    import dlrm_tpu
    from dlrm_tpu.parallel.mesh import make_mesh
    from dlrm_tpu.parallel.placement import plan_placement

    config_pack = dlrm_tpu.DLRMConfig(
        bottom_mlp_sizes=(13, 512, 256, feature_size),
        top_mlp_sizes=(1024, 1024, 512, 256, 1),
        feature_size=feature_size,
        table_sizes=(AUDIT_ROWS,) * 26).pack
    mesh = make_mesh(n_devices)
    p = plan_placement(
        (AUDIT_ROWS,) * 26, n_devices, pack=config_pack,
        max_rows_per_shard=AUDIT_ROWS // 2 if row_shard else None)
    pre, hlo = _lower_step_hlo(mesh, p, batch_per_chip, feature_size,
                               exchange_dtype=exchange_dtype)
    cols = collect_collectives(hlo)
    by_kind = defaultdict(lambda: [0, 0.0])
    total_link = 0.0
    for kind, rb, gsz, _ in cols:
        lb = link_bytes(kind, rb, gsz or n_devices)
        by_kind[kind][0] += 1
        by_kind[kind][1] += lb
        total_link += lb
    saved = (sum(exchange_savings(pre).values())
             if exchange_dtype is not None else 0.0)
    return by_kind, total_link, len(cols), saved


def audit_hybrid(dcn: int, ici: int, batch_per_chip: int,
                 feature_size: int = 16, exchange_dtype=None):
    """The 2-D DCN x ICI hybrid step (tables sharded over ICI only,
    batch over both axes, sparse updates DCN-folded): classify every
    collective by the mesh axis it rides and total the traffic per axis.
    Quantifies the compressed `_dcn_fold` claim — DCN carries (ids,
    grad-rows) pairs proportional to the batch, never table-sized
    payloads."""
    import dlrm_tpu
    from dlrm_tpu.parallel.mesh import make_mesh_2d
    from dlrm_tpu.parallel.placement import plan_placement

    config_pack = dlrm_tpu.DLRMConfig(
        bottom_mlp_sizes=(13, 512, 256, feature_size),
        top_mlp_sizes=(1024, 1024, 512, 256, 1),
        feature_size=feature_size,
        table_sizes=(AUDIT_ROWS,) * 26).pack
    mesh = make_mesh_2d(dcn, ici)
    p = plan_placement((AUDIT_ROWS,) * 26, ici, pack=config_pack)
    pre, hlo = _lower_step_hlo(mesh, p, batch_per_chip, feature_size,
                               exchange_dtype=exchange_dtype)
    per_axis = defaultdict(lambda: defaultdict(lambda: [0, 0.0]))
    totals = defaultdict(float)
    for kind, rb, gsz, axis in collect_collectives(hlo, ici=ici):
        lb = link_bytes(kind, rb, gsz or dcn * ici)
        per_axis[axis][kind][0] += 1
        per_axis[axis][kind][1] += lb
        totals[axis] += lb
    saved = (exchange_savings(pre, ici=ici)
             if exchange_dtype is not None else {})
    return per_axis, totals, saved


def _xd(args):
    if getattr(args, "exchange_dtype", None) == "bf16":
        import jax.numpy as jnp
        return jnp.bfloat16
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-per-chip", type=int, default=4096)
    ap.add_argument("--feature-size", type=int, default=16)
    ap.add_argument("--mesh", type=int, nargs="*", default=[2, 4, 8])
    ap.add_argument("--hybrid", type=int, nargs=2, metavar=("DCN", "ICI"),
                    default=None, help="audit the 2-D DCN x ICI hybrid "
                    "step instead, classifying traffic per mesh axis")
    ap.add_argument("--row-shard", action="store_true")
    ap.add_argument("--exchange-dtype", default=None, choices=["bf16"],
                    help="compress the embedding exchanges to bf16 "
                    "(config.exchange_dtype) and measure the collective "
                    "bytes that actually result")
    args = ap.parse_args()

    import os
    need = max(args.mesh, default=1)
    if args.hybrid:
        need = max(need, args.hybrid[0] * args.hybrid[1])
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={need}"
        ).strip()
    import jax
    jax.config.update("jax_platforms", "cpu")

    print(f"batch/chip={args.batch_per_chip} fs={args.feature_size} "
          f"(26 tables, production MLP shapes)")
    if args.hybrid:
        dcn, ici = args.hybrid
        per_axis, totals, saved = audit_hybrid(dcn, ici,
                                               args.batch_per_chip,
                                               args.feature_size,
                                               exchange_dtype=_xd(args))
        print(f"\nhybrid mesh {dcn}x{ici} (dcn x ici):")
        for axis in ("ici", "dcn", "mesh"):
            if axis not in per_axis:
                continue
            wire = ""
            if saved.get(axis):
                wire = (f"  -> {(totals[axis] - saved[axis]) / 1e6:.2f}"
                        " MB wire on the GPU (bf16 exchange; CPU lowering "
                        "widens sub-f32 collectives)")
            print(f"  [{axis}] {totals[axis] / 1e6:.2f} MB/chip/step"
                  + wire)
            for kind, (cnt, bts) in sorted(per_axis[axis].items()):
                print(f"    {kind:20s} x{cnt:3d}  {bts / 1e6:8.2f} MB/chip")
        return
    for n in args.mesh:
        by_kind, total_link, n_ops, saved = audit(
            n, args.batch_per_chip, args.feature_size,
            row_shard=args.row_shard, exchange_dtype=_xd(args))
        wire_link = total_link - saved
        print(f"\nmesh={n}: {n_ops} collectives, "
              f"{total_link / 1e6:.1f} MB/chip/step link traffic"
              + (f" -> {wire_link / 1e6:.1f} MB wire on the GPU (bf16 "
                 "exchange, measured from the program's wire dtypes; "
                 "the CPU lowering widens sub-f32 collectives to f32)"
                 if saved else ""))
        for kind, (cnt, bts) in sorted(by_kind.items()):
            print(f"  {kind:20s} x{cnt:3d}  {bts / 1e6:8.2f} MB/chip")


if __name__ == "__main__":
    main()
