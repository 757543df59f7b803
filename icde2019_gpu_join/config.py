"""Engine configuration: radix geometry, tile sizes, placement policy.

This is the engine's replacement of the reference's three config tiers
(reference src/common.h:49-97 constexpr radix geometry, compile-time MEM_TYPE
macros src/common.h:74-86, and getopt CLI src/main.cu:434-557): one pytree
dataclass, no macros.

Reference geometry reproduced for parity of the *partitioning function*
(the set of rows per partition), not the storage layout:
  - hash is identity: hasht(x) = x   (reference src/common.h:45-47)
  - partition id     = (uint32(key) >> first_bit) & (2^bits - 1)
  - default radix width 13 bits = log_parts1(8) + log_parts2(5)
    (reference src/common.h:51-52), but the blocked probe partitions deeper
    by default because it is a blocked compare over small tiles rather
    than a shared-memory hash table: smaller partitions = linear probe cost.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# --- Reference radix constants (src/common.h:51-71), kept for parity modes ---
LOG_PARTS1 = 8
LOG_PARTS2 = 5
REF_RADIX_BITS = LOG_PARTS1 + LOG_PARTS2  # 13: the reference's final fanout
REF_BUCKET_SIZE = 4096                    # reference bucket-chain granularity
REF_CHAIN_THRESHOLD = 2 * REF_BUCKET_SIZE # decompose_chains threshold (8192)
CHUNK_SIZE = 1 << 31                      # streaming segment bound (common.h:49)

PROBE_MODES = ("auto", "banded", "blocked", "sort_merge")


def hasht(x):
    """Identity hash, as in the reference (src/common.h:45-47).

    Partitioning is pure radix on key bits. Kept as a function hook so a
    non-identity hash can be swapped in without touching the kernels.
    """
    return x


@dataclasses.dataclass(frozen=True)
class RadixConfig:
    """Radix-partitioning geometry.

    total_bits: total radix width; 2^total_bits final partitions.
    first_bit:  low bit of the radix field (reference passes first_bit=0,
                src/hash_join_clustered_probe.cu:877).
    bits_per_pass: fanout per Pallas partition pass (multi-pass plan).
    """

    total_bits: int = REF_RADIX_BITS
    first_bit: int = 0
    bits_per_pass: int = 8

    @property
    def num_partitions(self) -> int:
        return 1 << self.total_bits

    @property
    def mask(self) -> int:
        return self.num_partitions - 1

    def pass_plan(self) -> Tuple[Tuple[int, int], ...]:
        """MSB-first multi-pass plan: tuples of (shift, bits).

        Pass k partitions on bits [shift, shift+bits) of the hashed key,
        mirroring the reference's MSB-first two-pass scheme
        (prepare_Relation_payload, src/join-primitives.cu:1582-1613: pass 1
        on bits [first_bit+log_parts2, ...), pass 2 on [first_bit, ...)).
        """
        plan = []
        remaining = self.total_bits
        hi = self.first_bit + self.total_bits
        while remaining > 0:
            b = min(self.bits_per_pass, remaining)
            hi -= b
            plan.append((hi, b))
            remaining -= b
        return tuple(plan)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level engine knobs (the reference's `args` struct analog,
    src/common-host.h:39-52, plus the engine's own tiling)."""

    radix: RadixConfig = dataclasses.field(default_factory=RadixConfig)

    # Probe tiling: R rows per work item x S rows per work item.
    probe_tile_r: int = 256
    probe_tile_s: int = 256

    # Skew: a partition whose count exceeds this many probe tiles is split
    # into multiple work items (the decompose_chains analog,
    # reference src/join-primitives.cu:843-874).
    max_tiles_per_item: int = 1

    # Probe strategy: one of PROBE_MODES. "auto" resolves to the banded
    # sort-merge probe (ops/band_join.py).
    probe_mode: str = "auto"

    # Banded probe: R-blocks (x128 rows) gathered per round per S block.
    # W=1 is the default; the best W on the GPU is not measured yet.
    band_window_blocks: int = 1

    # Streaming: probe-side segment size in rows (Join3 analog,
    # reference src/hash_join_clustered_probe.cu:1017: min(CHUNK_SIZE, n/4)).
    segment_rows: Optional[int] = None

    # Placement: "hbm" (device-resident) or "host" (host RAM, streamed in),
    # the MEM_TYPE analog (reference src/common.h:74-86).
    build_placement: str = "hbm"
    probe_placement: str = "hbm"

    # Materialization ring-buffer capacity in pairs; mirrors the reference's
    # FOLD = 2^24-1 output ring (src/join-primitives.cu:1099-1101). Writes
    # wrap modulo this capacity.
    out_capacity: int = 1 << 24

    # In-chip dispatcher threshold, rows (reference hj_ClusteredProbe
    # dispatches Join1/Join2/Join3 at 128e6+1, hash_join_clustered_probe.cu:2001).
    resident_limit_rows: int = 128_000_001

    # Hot-path (sortval, payload) sort: None = the process default
    # (JOIN_SORT_IMPL env, default "lax"); "lax" | "packed" is resolved per
    # CALL and threaded as a jit static argument, so two engines with
    # different sort_impl coexist in one process and no cache clearing
    # ever happens (see ops.band_join.resolve_sort_impl).
    sort_impl: Optional[str] = None

    def __post_init__(self):
        if self.probe_mode not in PROBE_MODES:
            raise ValueError(f"unknown probe_mode {self.probe_mode!r}: "
                             f"expected one of {PROBE_MODES}")
        if self.sort_impl is not None:
            from icde2019_gpu_join.ops.band_join import resolve_sort_impl
            resolve_sort_impl(self.sort_impl)

    def with_bits(self, total_bits: int) -> "EngineConfig":
        return dataclasses.replace(
            self, radix=dataclasses.replace(self.radix, total_bits=total_bits)
        )


def default_bits_for(n_rows: int, tile: int = 256) -> int:
    """Pick a radix width so the average partition fits one probe tile.

    The blocked-compare probe costs sum_p |R_p| * |S_p|; sizing partitions
    to ~tile rows keeps that linear in n. Clamped to [4, 22].
    """
    bits = max(4, (max(n_rows, 1) // max(tile, 1)).bit_length())
    return min(bits, 22)
