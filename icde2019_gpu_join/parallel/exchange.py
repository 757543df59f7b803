"""Distributed radix shuffle: per-chip partition by destination + all_to_all.

The engine's replacement for the reference's only "interconnect" — PCIe
cudaMemcpyAsync streams (SURVEY.md §2 P8, src/hash_join_clustered_probe.cu:
1312-1330). Each chip partitions its local shard by destination chip (the
radix field's low bits), lays each destination bucket into a static padded
frame, and one jax.lax.all_to_all over the mesh axis delivers every row to
the chip owning its key range.

Exchange invariant: the multiset of rows with payload != 0 is preserved.
Padding rows always carry payload 0, which contributes exactly nothing to
SUM(Pr*Ps) — aggregates and counts-as-sums are exact without dynamic
shapes. Overflowed rows (a bucket exceeding its cap) are counted and
returned; with caps from plan.plan_cap (exact histogram pre-pass) overflow
is impossible by construction.

Two bucketing methods:

* `partition_to_buckets` (sort-based): ONE 2-operand unstable sort of
  (rotated key, payload) groups by destination AND key-orders within.
  Frame extraction is BLOCK-aligned (one 128-row alignment block of slack
  per bucket, zero element gathers, which an earlier element-level
  `keys_s[idx]` gather version needed).
  Emits (start, count) metadata per bucket so a receiver can reconstruct
  the exact valid mask (the valid-aware two-level path).
* `partition_to_buckets_grouped` (radix_group-based): grouping WITHOUT
  within-bucket order, at the price of ~one boundary block per (chunk,
  destination) run of interior padding; meant for receivers that re-sort
  anyway (the 1-level aggregate path). Its speed against the sort method
  on the GPU is not measured yet.

Determinism: bucket contents are deterministic as MULTISETS (fully
sufficient for the engine's commutative wraparound aggregates); row order
within a bucket is key-sorted for the sort method and unspecified for the
grouped method.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from icde2019_gpu_join.ops.bits import (
    partition_boundaries,
    rotate_keys,
    unrotate_keys,
)

_BLK = 128
_SENT = jnp.int32(0x7FFFFFFF)  # sorts strictly after every real row: keys
# are >= 0 (engine key-domain contract), so the rotated sortval always has
# a zero bit at position 31-s and tops out below 0x7FFFFFFF.


class BucketFrames(NamedTuple):
    keys: jnp.ndarray     # [num_buckets, frame_rows] int32
    pays: jnp.ndarray     # [num_buckets, frame_rows] int32
    start: jnp.ndarray    # [num_buckets] first valid slot of each frame
    count: jnp.ndarray    # [num_buckets] valid rows per frame
    overflow: jnp.ndarray  # scalar int32: rows dropped (0 => exact)


def frame_rows(cap: int) -> int:
    """Frame width for a bucket cap: cap + one 128-row alignment block."""
    assert cap % _BLK == 0, "cap must be a 128 multiple (plan.plan_cap)"
    return cap + _BLK


def _spread_pad_keys(gidx: jnp.ndarray) -> jnp.ndarray:
    """Non-negative pad keys spread over the key space (Knuth multiplicative
    hash of the slot index) so downstream re-bucketing or banded probing
    never sees a quadratic run of equal pad keys; payloads are 0, so an
    accidental match with a real key contributes nothing."""
    return ((gidx.astype(jnp.uint32) * jnp.uint32(2654435761))
            >> jnp.uint32(1)).astype(jnp.int32)


def partition_to_buckets(
    keys: jnp.ndarray,
    pays: jnp.ndarray,
    num_buckets: int,
    cap: int,
    first_bit: int,
    valid: Optional[jnp.ndarray] = None,
) -> BucketFrames:
    """Sort-based bucketing into block-aligned frames (see module doc).

    `valid`: optional bool mask; invalid rows are sentinel-masked out of
    every bucket (they count toward no cap and never ride the exchange
    as live rows) — this is what keeps two-level caps exact in the face
    of level-1 frame padding.
    """
    assert num_buckets & (num_buckets - 1) == 0, "num_buckets must be 2^k"
    if num_buckets == 1:
        # Degenerate mesh (1 device): every row belongs to bucket 0. A
        # bits>=1 sort would route half the rows to a phantom bucket, so
        # handle this explicitly: sort (valid rows to the front as a
        # prefix), take up to cap, emit one padded frame.
        rot = rotate_keys(keys, 0, first_bit)
        if valid is not None:
            rot = jnp.where(valid, rot, _SENT)
            pays = jnp.where(valid, pays, 0)
            count = jnp.sum(valid.astype(jnp.int32))
        else:
            count = jnp.int32(keys.shape[0])
        F = frame_rows(cap)
        n = rot.shape[0]
        if n < F:
            rot = jnp.concatenate([rot, jnp.full((F - n,), _SENT, jnp.int32)])
            pays = jnp.concatenate([pays, jnp.zeros((F - n,), jnp.int32)])
        rot_s, pays_s = jax.lax.sort((rot, pays), num_keys=1, is_stable=False)
        take = jnp.minimum(count, cap).astype(jnp.int32)
        idx = jnp.arange(F, dtype=jnp.int32)
        live = idx < take
        out_k = jnp.where(live, unrotate_keys(rot_s[:F], 0, first_bit),
                          _spread_pad_keys(idx))
        out_p = jnp.where(live, pays_s[:F], 0)
        return BucketFrames(
            out_k[None, :], out_p[None, :],
            jnp.zeros(1, jnp.int32), take.reshape(1),
            (count - take).astype(jnp.int32))
    bits = (num_buckets - 1).bit_length()
    rot = rotate_keys(keys, bits, first_bit)
    if valid is not None:
        rot = jnp.where(valid, rot, _SENT)
        pays = jnp.where(valid, pays, 0)
    n = rot.shape[0]
    pad = -n % _BLK
    if pad:
        rot = jnp.concatenate([rot, jnp.full((pad,), _SENT, jnp.int32)])
        pays = jnp.concatenate([pays, jnp.zeros((pad,), jnp.int32)])
    rot_s, pays_s = jax.lax.sort((rot, pays), num_keys=1, is_stable=False)

    bounds = jnp.concatenate(
        [partition_boundaries(bits), jnp.asarray([_SENT], jnp.int32)])
    offsets = jnp.searchsorted(rot_s, bounds, side="left").astype(jnp.int32)
    counts = jnp.diff(offsets)                       # real rows per bucket
    take = jnp.minimum(counts, cap)
    overflow = jnp.sum(counts - take)

    capb = cap // _BLK + 1                           # frame blocks
    nb = rot_s.shape[0] // _BLK
    b0 = offsets[:-1] // _BLK                        # [buckets]
    blk = b0[:, None] + jnp.arange(capb, dtype=jnp.int32)[None, :]
    blk_c = jnp.clip(blk.reshape(-1), 0, nb - 1)
    kb = jnp.take(rot_s.reshape(-1, _BLK), blk_c, axis=0)  # [bkts*capb, 128]
    vb = jnp.take(pays_s.reshape(-1, _BLK), blk_c, axis=0)
    gidx = (blk.reshape(-1, 1) * _BLK
            + jax.lax.broadcasted_iota(jnp.int32, (1, _BLK), 1))
    lo = jnp.repeat(offsets[:-1], capb)[:, None]
    hi = jnp.repeat(offsets[:-1] + take, capb)[:, None]
    live = (gidx >= lo) & (gidx < hi)
    out_k = jnp.where(live, unrotate_keys(kb, bits, first_bit),
                      _spread_pad_keys(gidx))
    out_p = jnp.where(live, vb, 0)
    F = capb * _BLK
    return BucketFrames(
        out_k.reshape(num_buckets, F), out_p.reshape(num_buckets, F),
        (offsets[:-1] - b0 * _BLK).astype(jnp.int32), take.astype(jnp.int32),
        overflow.astype(jnp.int32))


def partition_to_buckets_grouped(
    keys: jnp.ndarray,
    pays: jnp.ndarray,
    num_buckets: int,
    cap: int,
    first_bit: int,
    chunk: int = 4096,
) -> BucketFrames:
    """radix_group-based bucketing: grouping only, no within-bucket order
    (its speed against the sort on the GPU is not measured yet). Interior
    (chunk-run boundary) padding rows ride inside the frames, so `cap` must
    budget for them:
    use plan.plan_cap_grouped (cap rows + one block per chunk). `start`
    metadata is 0 and `count` counts VALID rows, but valid rows are NOT a
    prefix (interspersed pads) — this method does not support the
    valid-aware receiver; use it where the receiver re-sorts (1-level)."""
    from icde2019_gpu_join.ops.partition_radix import radix_group

    assert num_buckets & (num_buckets - 1) == 0, "num_buckets must be 2^k"
    if num_buckets == 1:
        # Degenerate mesh (1 device): pass-through into a single frame, no
        # grouping needed. Liveness is POSITIONAL (rows are an untouched
        # prefix), never a key-vs-sentinel compare: a real key of
        # 0x7FFFFFFF is in the engine key domain (keys >= 0) and must not
        # be mistaken for padding (round-4 review finding).
        F = (cap // _BLK) * _BLK
        n = keys.shape[0]
        if n < F:
            keys = jnp.concatenate([keys, jnp.zeros((F - n,), jnp.int32)])
            pays = jnp.concatenate([pays, jnp.zeros((F - n,), jnp.int32)])
        k = keys[:F]
        p = pays[:F]
        idx = jnp.arange(F, dtype=jnp.int32)
        live = idx < n
        out_k = jnp.where(live, k, _spread_pad_keys(idx))
        out_p = jnp.where(live, p, 0)
        dropped = jnp.int32(max(n - F, 0))
        return BucketFrames(
            out_k[None, :], out_p[None, :],
            jnp.zeros(1, jnp.int32),
            jnp.full((1,), min(n, F), jnp.int32),
            dropped)
    bits = (num_buckets - 1).bit_length()
    # rotation puts destination bits on top; radix_group groups by top bits
    rot = rotate_keys(keys, bits, first_bit)
    # radix_group's pid = top bits of the UNSIGNED view (it re-flips the
    # sign bit), while rotate_keys already emits sign-flipped sortvals whose
    # top bits ARE the destination — so feed it the raw rotated uint pattern
    # re-flipped to keep pid == destination.
    g = radix_group(rot, pays, bits, chunk)
    capb = cap // _BLK
    pb = g.block_offsets[1:] - g.block_offsets[:-1]
    take_b = jnp.minimum(pb, capb)
    # dropped blocks (only possible when cap was guessed, not planned);
    # upper-bound the dropped rows by a full block each
    overflow = jnp.sum(pb - take_b) * _BLK
    nb_tot = g.keys.shape[0] // _BLK
    blk = g.block_offsets[:-1][:, None] + jnp.arange(capb, dtype=jnp.int32)
    in_run = jnp.arange(capb, dtype=jnp.int32)[None, :] < take_b[:, None]
    blk_c = jnp.clip(blk.reshape(-1), 0, max(nb_tot - 1, 0))
    kb = jnp.take(g.keys.reshape(-1, _BLK), blk_c, axis=0)
    vb = jnp.take(g.pays.reshape(-1, _BLK), blk_c, axis=0)
    live = in_run.reshape(-1)[:, None] & (kb != _SENT)
    gidx = (blk.reshape(-1, 1) * _BLK
            + jax.lax.broadcasted_iota(jnp.int32, (1, _BLK), 1))
    out_k = jnp.where(live, unrotate_keys(kb, bits, first_bit),
                      _spread_pad_keys(gidx))
    out_p = jnp.where(live, vb, 0)
    F = capb * _BLK
    return BucketFrames(
        out_k.reshape(num_buckets, F), out_p.reshape(num_buckets, F),
        jnp.zeros(num_buckets, jnp.int32), g.counts[:num_buckets],
        overflow.astype(jnp.int32))


def all_to_all_exchange(
    bucket_keys: jnp.ndarray, bucket_pays: jnp.ndarray, axis: str
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Shuffle padded bucket frames over the mesh axis: row block d of my
    buckets goes to chip d; I receive one block from every chip. Must run
    inside shard_map over `axis`."""
    k = jax.lax.all_to_all(bucket_keys, axis, split_axis=0, concat_axis=0, tiled=True)
    p = jax.lax.all_to_all(bucket_pays, axis, split_axis=0, concat_axis=0, tiled=True)
    return k, p


def all_to_all_meta(start: jnp.ndarray, count: jnp.ndarray, axis: str
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exchange per-bucket (start, count) metadata alongside the frames so
    the receiver can reconstruct the exact valid mask of what it got."""
    s = jax.lax.all_to_all(start[:, None], axis, split_axis=0,
                           concat_axis=0, tiled=True)[:, 0]
    c = jax.lax.all_to_all(count[:, None], axis, split_axis=0,
                           concat_axis=0, tiled=True)[:, 0]
    return s, c


def frames_valid_mask(start: jnp.ndarray, count: jnp.ndarray,
                      frame: int) -> jnp.ndarray:
    """[num_buckets, frame] bool: which received slots hold real rows
    (sort-based frames only: valid rows are [start, start+count))."""
    j = jnp.arange(frame, dtype=jnp.int32)[None, :]
    return (j >= start[:, None]) & (j < (start + count)[:, None])
