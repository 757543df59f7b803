"""Radix partitioning into a dense CSR layout.

The engine's replacement for the reference's two-pass bucket-chain partitioner
(partition_pass_one / partition_pass_two, src/join-primitives.cu:58-535, and
their metadata init/repack, :294-312, :577-618). CUDA builds the layout with
atomicAdd histograms and lock-free bucket allocation; this engine uses
neither atomics nor random scatter and partitions *deterministically*:

    rotate radix field to top bits -> ONE (sortval, payload) sort
    -> CSR offsets via searchsorted on the sorted sortvals.

The rotation (ops/bits.rotate_keys) is bijective, so keys are recovered
exactly after the sort, and it subsumes the pid operand: a 2-operand sort
replaces the naive 3-operand (pid, key, payload) sort.

Engine layout contract: within a partition rows are ordered by the rotated
key — for first_bit=0 that is ascending key order. Payload order among
DUPLICATE keys is unspecified (the sort is not stable, and no join
semantics depend on it — the per-key payload multiset is preserved). The probe exploits sortedness; aggregates are order-insensitive.

Because the probe is a blocked compare rather than a shared-memory hash
table, total_bits is typically chosen deeper than the reference's 13 bits
(see config.default_bits_for): smaller partitions make probe cost linear.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from icde2019_gpu_join.ops.bits import (
    partition_boundaries,
    partition_ids,
    rotate_keys,
    unrotate_keys,
)
from icde2019_gpu_join.relation import PartitionedRelation


def histogram(keys: jnp.ndarray, total_bits: int, first_bit: int = 0) -> jnp.ndarray:
    """Per-partition row counts (the reference's out_cnts). Standalone op;
    the fused path derives counts from the sorted layout instead."""
    p = partition_ids(keys, total_bits, first_bit)
    return jnp.bincount(p, length=1 << total_bits).astype(jnp.int32)


def _csr_from_sorted_sortval(
    sv_sorted: jnp.ndarray, total_bits: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """counts/offsets from the sorted rotated keys via vectorized binary
    search against each partition's smallest possible sortval (cheap:
    (parts+1) * log n gathers)."""
    n = sv_sorted.shape[0]
    probes = partition_boundaries(total_bits)
    offsets = jnp.concatenate([
        jnp.searchsorted(sv_sorted, probes, side="left").astype(jnp.int32),
        jnp.full((1,), n, jnp.int32),
    ])
    counts = jnp.diff(offsets)
    return counts, offsets


def radix_partition(
    keys: jnp.ndarray,
    payload: jnp.ndarray,
    total_bits: int,
    first_bit: int = 0,
    sort_impl: str = None,
) -> PartitionedRelation:
    """Partition (keys, payload) into 2^total_bits partitions, CSR layout.

    One (rotated-key, payload) sort: groups by partition AND orders
    within each partition by the remaining key bits — subsumes the
    reference's two passes at any radix depth in one shot. sort_impl picks
    the hot sort (None = process default); jitted callers must pass it as
    a static argument.
    """
    sv = rotate_keys(keys, total_bits, first_bit)
    from icde2019_gpu_join.ops.band_join import sort_pairs
    sv_sorted, pays_s = sort_pairs(sv, payload, sort_impl)
    keys_s = unrotate_keys(sv_sorted, total_bits, first_bit)
    counts, offsets = _csr_from_sorted_sortval(sv_sorted, total_bits)
    return PartitionedRelation(keys_s, pays_s, counts, offsets, total_bits, first_bit)


def radix_partition_multipass(
    keys: jnp.ndarray,
    payload: jnp.ndarray,
    total_bits: int,
    first_bit: int = 0,
    bits_per_pass: int = 8,
) -> PartitionedRelation:
    """LSD multi-pass variant mirroring the reference's pass structure
    (prepare_Relation_payload, src/join-primitives.cu:1582-1613: bits
    [first_bit+log_parts2, +log_parts1) then [first_bit, +log_parts2)).

    Stable LSB-first passes over fields of the *rotated* key compose to the
    exact single-sort order of radix_partition (the reference's MSB recursion
    and LSB flat passes produce the same grouped layout). Exists to exercise
    the pass plan the Pallas kernels use and as their correctness oracle.
    """
    sv = rotate_keys(keys, total_bits, first_bit)
    u = sv.astype(jnp.uint32) ^ jnp.uint32(0x80000000)  # unsigned sort field
    v = payload
    nfields = -(-32 // bits_per_pass)
    mask = jnp.uint32((1 << bits_per_pass) - 1)
    for f in range(nfields):
        field = ((u >> jnp.uint32(f * bits_per_pass)) & mask).astype(jnp.int32)
        _, u, v = jax.lax.sort((field, u, v), num_keys=1, is_stable=True)  # LSD passes need stability
    sv_sorted = (u ^ jnp.uint32(0x80000000)).astype(jnp.int32)
    keys_s = unrotate_keys(sv_sorted, total_bits, first_bit)
    counts, offsets = _csr_from_sorted_sortval(sv_sorted, total_bits)
    return PartitionedRelation(keys_s, v, counts, offsets, total_bits, first_bit)
