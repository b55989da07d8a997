"""Model / mesh / training configuration.

The reference exposes configuration as Julia keyword arguments
(``dlrm(...)``, /root/reference/src/model/model.jl:173-192) plus preset model
builders (``kaggle_dlrm``, /root/reference/src/data/criteo.jl:408-433).  Here
configuration is a first-class frozen dataclass so it can be closed over by
jitted functions as static data.

Size math mirrors the reference exactly
(/root/reference/src/model/model.jl:214-229):

* ``pre_triangle = feature_size * num_tables / bottom_out + 1`` — the number
  of "features" entering the pairwise dot-product interaction (the +1 is the
  bottom-MLP output itself).
* ``top_input = pad(pre_triangle*(pre_triangle-1)/2 + bottom_out)`` — the
  lower-triangle pair count concatenated with the bottom-MLP output, padded up
  to ``interaction_pad_to`` (the reference's ``POST_INTERACTION_PAD_TO_MUL``,
  /root/reference/src/model/model.jl:32).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional, Sequence, Tuple

import jax.numpy as jnp

NUM_DENSE_FEATURES = 13  # Criteo continuous features (criteo.jl:88)
NUM_SPARSE_FEATURES = 26  # Criteo categorical features (criteo.jl:89)

# Criteo Kaggle DAC vocabulary sizes (/root/reference/src/data/criteo.jl:350-377).
KAGGLE_TABLE_SIZES: Tuple[int, ...] = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)

# Criteo Terabyte vocabulary sizes (/root/reference/src/data/criteo.jl:379-406).
TERABYTE_TABLE_SIZES: Tuple[int, ...] = (
    227605432, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 130229467,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 292775614, 40790948,
    187188510, 590152, 12973, 108, 36,
)


INTERACTION_IMPLS = ("gram", "pairwise", "fused")


def _round_up(x: int, m: int) -> int:
    return m * ((x + m - 1) // m)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """Static description of one DLRM topology.

    Attributes:
      bottom_mlp_sizes: layer widths of the bottom (dense) MLP *including* the
        input width, e.g. ``(13, 512, 256, 16)``.  Every layer uses ReLU
        (the reference passes ``sigmoid_index=0`` for the bottom MLP,
        model.jl:209, so no layer gets sigmoid).
      top_mlp_sizes: layer widths of the top MLP *excluding* the input width
        (which is derived), e.g. ``(512, 256, 1)``.  The final layer is
        linear + sigmoid; all others ReLU (model.jl:230 passes
        ``sigmoid_index = lastindex``).
      feature_size: embedding dimension shared by all tables.
      table_sizes: rows per embedding table.
      n_hot: lookups per sample per table (1 = one-hot; >1 = multi-hot with
        sum pooling, matching EmbeddingTables' pooled lookup as exercised by
        ref/pytorch_reference_multi.hdf5).
      interaction_pad_to: pad the interaction output width up to a multiple of
        this (reference knob ``POST_INTERACTION_PAD_TO_MUL``).  Padded entries
        are zeros; the top MLP input width includes the padding.
      weight_dtype / embedding_dtype: parameter storage dtypes.
      compute_dtype: dtype for MLP/interaction math (bf16 for speed; f32,
        the default, for fixture parity).
    """

    bottom_mlp_sizes: Tuple[int, ...]
    top_mlp_sizes: Tuple[int, ...]
    feature_size: int
    table_sizes: Tuple[int, ...]
    n_hot: int = 1
    interaction_pad_to: int = 1
    # Rematerialize the dense tower on backward (jax.checkpoint around
    # forward_from_pooled): recompute interaction + MLP activations
    # instead of storing them — trades FLOPs for HBM at big batches /
    # feature sizes.  Semantically the identity; off by default (the
    # fs=16 B=32k step is scatter-bound, not activation-bound).
    remat: bool = False
    # Wire dtype for the sharded embedding exchanges (slot/cs all_to_all,
    # rs psum_scatter/all_gather, cross-host gradient fold) — None keeps
    # the operand dtype; jnp.bfloat16 halves the per-step collective
    # bytes (SCALING.md: the fs=128 pooled a2a is 117 MB/chip at an
    # 8-mesh, the dominant collective).  Numerics: exactly one rounding
    # at each exchange boundary (parallel/embedding._xc; multi-hot
    # row-sharded partials take one extra rounding per owning shard).
    exchange_dtype: Optional[jnp.dtype] = None
    weight_dtype: jnp.dtype = jnp.float32
    embedding_dtype: jnp.dtype = jnp.float32
    compute_dtype: jnp.dtype = jnp.float32
    seed: int = 51234  # reference seeds its RNG with 51234 (model.jl:193)
    # Interaction implementation: "gram" (batched einsum + static gather,
    # the plain reference), "pairwise" (elementwise pair dots), or "fused"
    # (the GPU kernel, ops/interaction_triton.py; one device's batch per
    # call).  All are oracle-tested (tests/test_interaction.py); the CLI
    # picks one with default_interaction_impl.
    interaction_impl: str = "gram"
    # Tables with <= this many rows use the one-hot matmul lookup/update
    # path instead of gather/scatter (ops/embedding.partition_tables); 0
    # disables.  The matmul sums duplicate-id gradients without a scatter.
    small_table_threshold: int = 8192
    # Lane-packed, chunked table storage (the "engine" format):
    # * PACK = 128 // feature_size logical rows per 128-wide physical row,
    #   so a narrow (R, 16) table is gathered and scattered as full
    #   512-byte rows.
    # * The packed stack is split into chunks of <= chunk_budget_bytes
    #   (whole tables, first-fit-decreasing), so each chunk's update is an
    #   independent scatter.
    # Lane packing auto-disables when feature_size doesn't divide 128.
    # 16 MB effectively gives every deep table its own chunk while
    # bundling the rest; chunk count stays O(num_tables), never
    # O(total_bytes / budget), because oversize tables are single chunks.
    # Whether packing and chunking pay on the GPU is not yet measured.
    packed_tables: bool = True
    chunk_budget_bytes: int = 16 << 20
    # Optional second budget for deep tables (rows > deep_table_rows); the
    # default keeps a single budget, and the knob remains for other batch
    # sizes / topologies.
    deep_table_rows: int = 1 << 20
    deep_chunk_budget_bytes: int = 16 << 20

    def __post_init__(self):
        object.__setattr__(self, "bottom_mlp_sizes", tuple(self.bottom_mlp_sizes))
        object.__setattr__(self, "top_mlp_sizes", tuple(self.top_mlp_sizes))
        object.__setattr__(self, "table_sizes", tuple(self.table_sizes))
        if self.interaction_impl not in INTERACTION_IMPLS:
            raise ValueError(
                f"interaction_impl {self.interaction_impl!r}: choose from "
                f"{INTERACTION_IMPLS}")
        if (self.feature_size * self.num_tables) % self.bottom_out != 0:
            raise ValueError(
                "feature_size * num_tables must be divisible by the bottom MLP "
                f"output width (got {self.feature_size} * {self.num_tables} "
                f"vs {self.bottom_out}); mirrors model.jl:220"
            )

    # -- derived sizes ------------------------------------------------------
    @property
    def num_dense(self) -> int:
        return self.bottom_mlp_sizes[0]

    @property
    def num_tables(self) -> int:
        return len(self.table_sizes)

    @property
    def bottom_out(self) -> int:
        return self.bottom_mlp_sizes[-1]

    @property
    def pre_triangle(self) -> int:
        """Feature count entering the pairwise interaction (model.jl:221)."""
        return self.feature_size * self.num_tables // self.bottom_out + 1

    @property
    def num_pairs(self) -> int:
        p = self.pre_triangle
        return (p * p - p) // 2

    @property
    def interaction_padding(self) -> int:
        raw = self.num_pairs + self.bottom_out
        return _round_up(raw, self.interaction_pad_to) - raw

    @property
    def top_input(self) -> int:
        """Top-MLP input width, incl. padding (model.jl:223-227)."""
        return self.num_pairs + self.bottom_out + self.interaction_padding

    @property
    def full_top_mlp_sizes(self) -> Tuple[int, ...]:
        return (self.top_input,) + self.top_mlp_sizes

    @cached_property
    def table_offsets(self) -> Tuple[int, ...]:
        """Row offset of each table inside the stacked embedding array."""
        off, out = 0, []
        for n in self.table_sizes:
            out.append(off)
            off += n
        return tuple(out)

    @property
    def total_rows(self) -> int:
        return sum(self.table_sizes)

    # -- lane-packed, chunked storage geometry (see packed_tables) -----------
    @property
    def pack(self) -> int:
        """Logical rows per physical storage row (1 = no lane packing)."""
        if not self.packed_tables:
            return 1
        if self.feature_size > 128 or 128 % self.feature_size != 0:
            return 1
        return 128 // self.feature_size

    @property
    def is_packed(self) -> bool:
        """True when the engine storage format (chunked, lane-packed) is in
        use — i.e. params['emb'] is a tuple of chunk arrays."""
        return self.packed_tables

    @property
    def row_width(self) -> int:
        """Lane width of one physical storage row."""
        return self.feature_size * self.pack

    @cached_property
    def packed_table_rows(self) -> Tuple[int, ...]:
        """Physical rows per table (each table padded to a whole number of
        physical rows so tables never share one)."""
        p = self.pack
        return tuple((n + p - 1) // p for n in self.table_sizes)

    @property
    def packed_total_rows(self) -> int:
        return sum(self.packed_table_rows)

    @cached_property
    def table_chunk(self) -> Tuple[int, ...]:
        """Chunk index of each table: two-level first-fit-decreasing by
        packed bytes — deep tables (rows > deep_table_rows) binned at
        deep_chunk_budget_bytes, the rest at chunk_budget_bytes; an
        oversize table gets its own chunk."""
        row_bytes = self.row_width * jnp.dtype(self.embedding_dtype).itemsize
        assign = [0] * self.num_tables
        next_chunk = 0

        def ffd(tables, budget):
            nonlocal next_chunk
            budget = max(int(budget), 1)
            order = sorted(tables,
                           key=lambda t: (-self.packed_table_rows[t], t))
            bins: list = []  # [(chunk_id, used_bytes)]
            for t in order:
                b = self.packed_table_rows[t] * row_bytes
                for i, (cid, used) in enumerate(bins):
                    if used + b <= budget:
                        bins[i] = (cid, used + b)
                        assign[t] = cid
                        break
                else:
                    bins.append((next_chunk, b))
                    assign[t] = next_chunk
                    next_chunk += 1

        deep = [t for t in range(self.num_tables)
                if self.table_sizes[t] > self.deep_table_rows]
        shallow = [t for t in range(self.num_tables)
                   if self.table_sizes[t] <= self.deep_table_rows]
        ffd(deep, self.deep_chunk_budget_bytes)
        ffd(shallow, self.chunk_budget_bytes)
        return tuple(assign)

    @property
    def num_chunks(self) -> int:
        return max(self.table_chunk) + 1

    @cached_property
    def chunk_table_offsets(self) -> Tuple[int, ...]:
        """Physical row offset of each table inside its chunk (tables laid
        out within a chunk in ascending table order)."""
        used = [0] * self.num_chunks
        out = [0] * self.num_tables
        for t in range(self.num_tables):
            c = self.table_chunk[t]
            out[t] = used[c]
            used[c] += self.packed_table_rows[t]
        return tuple(out)

    @cached_property
    def chunk_rows(self) -> Tuple[int, ...]:
        used = [0] * self.num_chunks
        for t in range(self.num_tables):
            used[self.table_chunk[t]] += self.packed_table_rows[t]
        return tuple(used)

    @cached_property
    def emb_shapes(self) -> Tuple[Tuple[int, int], ...]:
        """Storage shapes of the embedding parameter: one (rows, width) per
        chunk in engine format, or a single (total_rows, D) plain stack."""
        if self.is_packed:
            w = self.row_width
            return tuple((r, w) for r in self.chunk_rows)
        return ((self.total_rows, self.feature_size),)


def auto_chunk_budget_bytes(batch_size: int) -> int:
    """Chunk budget default — uniform 16 MB at every batch size.

    A batch-keyed budget was tried on the previous accelerator and did not
    replicate, so the default is uniform; the signature stays so a
    replicated optimum on the GPU can slot back in, and --chunk-budget-mb
    remains the explicit override.
    """
    del batch_size
    return 16 << 20


def default_interaction_impl(config: "DLRMConfig", platform: str,
                             one_device: bool) -> str:
    """The interaction a run uses when none is asked for: the fused kernel
    where it compiles (a GPU) and runs whole (one device: under a mesh the
    kernel would see the global batch) at a shape it takes; the gram
    reference otherwise.  Measured on the H100 (PERF.md): the fused kernel
    is faster end to end at Kaggle fs=16 and fs=128."""
    from dlrm_tpu.ops.interaction_triton import supported

    if (platform == "gpu" and one_device
            and supported(config.pre_triangle, config.bottom_out)):
        return "fused"
    return "gram"


# -- presets -----------------------------------------------------------------

def fixture_config() -> DLRMConfig:
    """Topology of ref/pytorch_reference_single.hdf5 (7 tables of 1000x16)."""
    return DLRMConfig(
        bottom_mlp_sizes=(13, 512, 256, 64, 16),
        top_mlp_sizes=(512, 256, 1),
        feature_size=16,
        table_sizes=(1000,) * 7,
    )


def multi_fixture_config() -> DLRMConfig:
    """Topology of ref/pytorch_reference_multi.hdf5 (10-hot pooled lookups)."""
    return dataclasses.replace(fixture_config(), n_hot=10)


def kaggle_config(feature_size: int = 16, **kw) -> DLRMConfig:
    """Criteo Kaggle DLRM (criteo.jl:408-433): bottom [13,512,256,fs],
    top [·,1024,1024,512,256,1], 26 tables, ~33.8M total rows."""
    return DLRMConfig(
        bottom_mlp_sizes=(13, 512, 256, feature_size),
        top_mlp_sizes=(1024, 1024, 512, 256, 1),
        feature_size=feature_size,
        table_sizes=KAGGLE_TABLE_SIZES,
        **kw,
    )


def terabyte_config(feature_size: int = 128, **kw) -> DLRMConfig:
    """Criteo Terabyte / MLPerf-scale DLRM (criteo.jl:379-406)."""
    return DLRMConfig(
        bottom_mlp_sizes=(13, 512, 256, feature_size),
        top_mlp_sizes=(1024, 1024, 512, 256, 1),
        feature_size=feature_size,
        table_sizes=TERABYTE_TABLE_SIZES,
        **kw,
    )


def tiny_config(num_tables: int = 4, rows: int = 32, feature_size: int = 8,
                n_hot: int = 1) -> DLRMConfig:
    """Small config for unit tests and multi-chip dry runs."""
    return DLRMConfig(
        bottom_mlp_sizes=(13, 16, feature_size),
        top_mlp_sizes=(16, 1),
        feature_size=feature_size,
        table_sizes=(rows,) * num_tables,
        n_hot=n_hot,
    )
