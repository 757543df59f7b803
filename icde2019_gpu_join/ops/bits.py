"""Radix partition-id computation.

The reference computes `partition = (hasht(key) >> first_bit) & parts_mask`
with hasht = identity (src/common.h:45-47, src/join-primitives.cu:131). Keys
are int32 but hashed as uint32, so the shift is logical, not arithmetic.
"""

from __future__ import annotations

import jax.numpy as jnp

from icde2019_gpu_join.config import hasht


def partition_ids(keys: jnp.ndarray, total_bits: int, first_bit: int = 0) -> jnp.ndarray:
    """int32 partition id in [0, 2^total_bits) for each key."""
    u = hasht(keys.astype(jnp.uint32))
    mask = jnp.uint32((1 << total_bits) - 1)
    return ((u >> jnp.uint32(first_bit)) & mask).astype(jnp.int32)


_SIGN = 0x80000000


def rotate_keys(keys: jnp.ndarray, total_bits: int, first_bit: int = 0) -> jnp.ndarray:
    """Bijective key packing: rotate the radix field to the top bits.

    rotr(key, first_bit + total_bits) places bits [first_bit,
    first_bit+total_bits) at the top of the word, so ONE comparison sort on
    the rotated value groups by partition id AND orders within a partition
    (for first_bit=0: by the remaining key bits, i.e. fully key-sorted
    partitions). The sign bit is flipped so signed int32 comparisons give
    unsigned order. This replaces a 2-operand (pid, key) sort with a
    1-operand sort.
    """
    s = (first_bit + total_bits) % 32
    u = hasht(keys.astype(jnp.uint32))
    if s:
        u = (u >> jnp.uint32(s)) | (u << jnp.uint32(32 - s))
    return (u ^ jnp.uint32(_SIGN)).astype(jnp.int32)


def unrotate_keys(sortval: jnp.ndarray, total_bits: int, first_bit: int = 0) -> jnp.ndarray:
    """Inverse of rotate_keys (exact key recovery)."""
    s = (first_bit + total_bits) % 32
    u = sortval.astype(jnp.uint32) ^ jnp.uint32(_SIGN)
    if s:
        u = (u << jnp.uint32(s)) | (u >> jnp.uint32(32 - s))
    return u.astype(jnp.int32)


def partition_boundaries(total_bits: int) -> jnp.ndarray:
    """Sorted-sortval probe values: the smallest sortval of each partition
    (for searchsorted-based CSR offsets). Shape [2^total_bits], int32."""
    parts = 1 << total_bits
    p = jnp.arange(parts, dtype=jnp.uint32)
    return ((p << jnp.uint32(32 - total_bits)) ^ jnp.uint32(_SIGN)).astype(jnp.int32)
