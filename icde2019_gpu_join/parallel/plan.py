"""Exchange planning: exact bucket caps from a histogram pre-pass.

Slack-guessed caps inflated all_to_all volume ~4x (and slack^2 in the
two-level path) and left callers asserting overflow == 0 with no retry
path. This module replaces guessing with measurement — the analog of the
reference's gain-driven scheduler re-planning
(src/partition-primitives.cu:381-469): ONE cheap jitted pre-pass computes
per-(chip, destination) row counts (one-hot histograms), the host derives
exact static caps from them, and overflow becomes impossible by
construction.

The pre-pass returns the full per-source-chip histogram (tiny: [ndev,
nbuckets] int32), so callers also get global per-destination totals for
heavy-hitter detection at no extra cost.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from icde2019_gpu_join.ops.bits import partition_ids

_BLK = 128


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def _local_hist(keys, bits: int, first_bit: int):
    """[2^bits] int32 destination histogram of one shard (one-hot
    compare-reduce — XLA fuses the iota compare into the reduction)."""
    pid = partition_ids(keys, bits, first_bit)
    nb = 1 << bits
    oh = pid[:, None] == jnp.arange(nb, dtype=jnp.int32)[None, :]
    return jnp.sum(oh.astype(jnp.int32), axis=0)


@functools.lru_cache(maxsize=64)
def _hist_fn_1d(mesh: Mesh, axis: str, bits: int, first_bit: int):
    def f(keys):
        return _local_hist(keys, bits, first_bit)[None, :]

    return jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(axis),), out_specs=P(axis, None)))


@functools.lru_cache(maxsize=64)
def _hist_fn_2d(mesh: Mesh, host_axis: str, chip_axis: str, bits: int,
                first_bit: int):
    def f(keys):
        return _local_hist(keys, bits, first_bit)[None, :]

    return jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P((host_axis, chip_axis)),),
        out_specs=P((host_axis, chip_axis), None)))


def destination_histograms(keys, mesh: Mesh, axis: str, num_buckets: int,
                           first_bit: int) -> np.ndarray:
    """[ndev, num_buckets] per-source-chip destination row counts (host
    numpy). One device pass + one small host pull."""
    if num_buckets == 1:
        # Degenerate fan-out: every row of a shard goes to bucket 0, so the
        # exact per-source count is the shard size — no device pass needed.
        # Exactness requires even sharding (the module-wide contract:
        # global lengths divide the mesh size), asserted here so a future
        # ragged caller fails loudly instead of gating on a wrong count.
        nd = mesh.shape[axis]
        assert keys.shape[0] % nd == 0, (
            "destination_histograms: shard lengths must divide the mesh")
        return np.full((nd, 1), keys.shape[0] // nd, dtype=np.int32)
    bits = (num_buckets - 1).bit_length()
    h = _hist_fn_1d(mesh, axis, bits, first_bit)(keys)
    return np.asarray(h)[:, :num_buckets]


def plan_cap(keys, mesh: Mesh, axis: str, num_buckets: int,
             first_bit: int = 0) -> int:
    """Exact static bucket cap (rows, 128-rounded) for a 1-level exchange:
    the max over (source chip, destination) of the real row count. With
    this cap, partition_to_buckets can never overflow."""
    hist = destination_histograms(keys, mesh, axis, num_buckets, first_bit)
    return max(_BLK, _round_up(hist.max(), _BLK))


def plan_caps_2level(
    keys, mesh: Mesh, host_axis: str, chip_axis: str, first_bit: int = 0,
) -> Tuple[int, int]:
    """Exact (cap_host, cap_chip) for the two-level exchange.

    Level 1 buckets rows by host bits [first_bit, first_bit+hbits); level 2
    by chip bits above them. Level-2 caps account for level-1 frame pad
    rows exactly: pads are sentinel-masked by the valid-aware second
    partition pass (exchange.partition_to_buckets(valid=...)), so they
    never enter any level-2 bucket — caps cover real rows only.
    """
    nh, nc = mesh.shape[host_axis], mesh.shape[chip_axis]
    hbits = (nh - 1).bit_length()  # 0 when the level is a single bucket
    cbits = (nc - 1).bit_length()
    h = _hist_fn_2d(mesh, host_axis, chip_axis, hbits + cbits, first_bit)(keys)
    joint = np.asarray(h).reshape(nh, nc, 1 << (hbits + cbits))
    # destination id bits: host = low hbits (at first_bit), chip = next cbits
    joint = joint[..., : nh * nc].reshape(nh, nc, nc, nh).transpose(0, 1, 3, 2)
    # joint[h0, c0, h, c] = rows on source chip (h0, c0) with host-bits h,
    # chip-bits c. (destination id d = h + (c << hbits) -> reshape [nc, nh]
    # then transpose.)
    per_host_counts = joint.sum(axis=3)              # [h0, c0, h]
    cap_h = max(_BLK, _round_up(per_host_counts.max(), _BLK))
    # level-2 input of chip (h, c0): sum over source hosts h0 of rows from
    # column c0 destined to host h — per level-2 destination c:
    recv = joint.sum(axis=0)                         # [c0, h, c]
    cap_c = max(_BLK, _round_up(recv.max(), _BLK))
    return cap_h, cap_c


@functools.lru_cache(maxsize=64)
def _grouped_blocks_fn(mesh: Mesh, axis: str, bits: int, first_bit: int,
                       chunk: int):
    from icde2019_gpu_join.ops.bits import rotate_keys
    from icde2019_gpu_join.ops.partition_radix import grouped_block_counts

    def f(keys):
        rot = rotate_keys(keys, bits, first_bit)
        return grouped_block_counts(rot, bits, chunk)[None, :]

    return jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(axis),), out_specs=P(axis, None)))


def plan_cap_grouped(keys, mesh: Mesh, axis: str, num_buckets: int,
                     first_bit: int = 0, chunk: int = 4096) -> int:
    """Exact static bucket cap (rows) for grouped frames
    (exchange.partition_to_buckets_grouped): the max over (source chip,
    destination) of the DESTINATION BLOCK count radix_group will emit —
    boundary-block and sentinel padding included exactly, so overflow is
    impossible by construction."""
    if num_buckets == 1:
        # single destination: the frame is a straight pass-through of the
        # shard (exchange's num_buckets==1 path), no grouping padding
        return max(_BLK, _round_up(keys.shape[0] // mesh.shape[axis], _BLK))
    bits = (num_buckets - 1).bit_length()
    pb = _grouped_blocks_fn(mesh, axis, bits, first_bit, chunk)(keys)
    return max(_BLK, int(np.asarray(pb).max()) * _BLK)


@functools.lru_cache(maxsize=64)
def _segmented_cap_fn(mesh: Mesh, axis: str, bits: int, first_bit: int,
                      segments: int, method: str, chunk: int):
    from icde2019_gpu_join.ops.bits import rotate_keys
    from icde2019_gpu_join.ops.partition_radix import grouped_block_counts

    def f(keys):
        ks = keys.reshape(segments, -1)
        if method == "group":
            per = jax.vmap(
                lambda k: grouped_block_counts(
                    rotate_keys(k, bits, first_bit), bits, chunk))(ks)
            return (jnp.max(per) * _BLK)[None]
        per = jax.vmap(lambda k: _local_hist(k, bits, first_bit))(ks)
        return jnp.max(per)[None]

    return jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(axis),), out_specs=P(axis)))


def plan_cap_segmented(keys, mesh: Mesh, axis: str, num_buckets: int,
                       first_bit: int, segments: int, method: str,
                       chunk: int = 4096) -> int:
    """Exact per-segment bucket cap for the segmented exchange: each chip's
    shard is cut into `segments` equal probe segments and bucketized
    independently — the cap is the max over (chip, segment, destination)
    of the real fill (rows for method='sort', laid-out block rows for
    method='group')."""
    if num_buckets == 1:
        seg_rows = keys.shape[0] // mesh.shape[axis] // segments
        return max(_BLK, _round_up(seg_rows, _BLK))
    bits = (num_buckets - 1).bit_length()
    m = _segmented_cap_fn(mesh, axis, bits, first_bit, segments, method,
                          chunk)(keys)
    return max(_BLK, _round_up(int(np.asarray(m).max()), _BLK))


def heavy_destinations(hist: np.ndarray, threshold_factor: float = 4.0
                       ) -> np.ndarray:
    """Destination ids whose GLOBAL row count exceeds threshold_factor x
    the uniform expectation — the distributed analog of decompose_chains'
    oversized-partition detection (src/join-primitives.cu:843-874).
    `hist` is destination_histograms output [ndev, nbuckets]."""
    totals = hist.sum(axis=0)
    expect = max(1.0, totals.sum() / hist.shape[1])
    return np.nonzero(totals > threshold_factor * expect)[0].astype(np.int32)


# --- Heavy-hitter split planning (PRPD skew handling) -----------------------
#
# The distributed analog of the reference's skew machinery
# (decompose_chains sub-chain splitting, src/join-primitives.cu:843-874, and
# the knapsack batcher, src/partition-primitives.cu:307-469): detect fine
# radix buckets whose probe-side row count would dominate one chip, then
# handle them PRPD-style (partial redistribution, partial duplication) —
# the matching build rows are all_gather-replicated to every chip and the
# heavy probe rows are joined where they already live (input placement is
# the balancer), while everything else rides the normal all_to_all.


class HeavySplitPlan:
    """Static plan for the heavy-split exchange (host-computed, hashable —
    feeds jit static args)."""

    def __init__(self, heavy_ids: Tuple[int, ...], fbits: int, cap_r: int,
                 cap_s: int, cap_rh: int, load_rows: np.ndarray):
        self.heavy_ids = tuple(int(h) for h in heavy_ids)
        self.fbits = int(fbits)
        self.cap_r = int(cap_r)    # normal R bucket cap (heavy excluded)
        self.cap_s = int(cap_s)    # normal S bucket cap (heavy excluded,
        #                            per segment when planned segmented)
        self.cap_rh = int(cap_rh)  # per-chip heavy-R broadcast frame rows
        self.load_rows = load_rows  # [ndev] projected probe rows per chip

    @property
    def split(self) -> bool:
        return len(self.heavy_ids) > 0


@functools.lru_cache(maxsize=64)
def _fine_hist_fn(mesh: Mesh, axis: str, bits: int, first_bit: int,
                  segments: int):
    """Per-(chip, segment) fine histogram via rotate+sort+searchsorted —
    one-hot compare-reduce is O(n * 2^bits) and unusable at fine widths."""
    from icde2019_gpu_join.ops.bits import (partition_boundaries,
                                            rotate_keys)

    def one(keys):
        rot_s = jnp.sort(rotate_keys(keys, bits, first_bit))
        bounds = jnp.concatenate(
            [partition_boundaries(bits),
             jnp.asarray([0x7FFFFFFF], jnp.int32)])
        offs = jnp.searchsorted(rot_s, bounds, side="left").astype(jnp.int32)
        return jnp.diff(offs)

    def f(keys):
        return jax.vmap(one)(keys.reshape(segments, -1))[None]

    return jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(axis),), out_specs=P(axis, None, None)))


def fine_histograms(keys, mesh: Mesh, axis: str, fbits: int,
                    first_bit: int = 0, segments: int = 1) -> np.ndarray:
    """[ndev, segments, 2^fbits] per-chip per-segment fine radix histogram
    (sort-based: usable at widths where one-hot histograms are not)."""
    return np.asarray(
        _fine_hist_fn(mesh, axis, fbits, first_bit, segments)(keys))


@functools.lru_cache(maxsize=64)
def _fine_hist_fn_2d(mesh: Mesh, host_axis: str, chip_axis: str, bits: int,
                     first_bit: int):
    """2D-mesh variant of _fine_hist_fn (one fine histogram per chip)."""
    from icde2019_gpu_join.ops.bits import (partition_boundaries,
                                            rotate_keys)

    def f(keys):
        rot_s = jnp.sort(rotate_keys(keys, bits, first_bit))
        bounds = jnp.concatenate(
            [partition_boundaries(bits),
             jnp.asarray([0x7FFFFFFF], jnp.int32)])
        offs = jnp.searchsorted(rot_s, bounds, side="left").astype(jnp.int32)
        return jnp.diff(offs)[None]

    return jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P((host_axis, chip_axis)),),
        out_specs=P((host_axis, chip_axis), None)))


def fine_histograms_2d(keys, mesh: Mesh, host_axis: str, chip_axis: str,
                       fbits: int, first_bit: int = 0) -> np.ndarray:
    """[nh*nc, 2^fbits] per-chip fine radix histogram over a 2D mesh
    (host-major chip order, matching the mesh's device linearization)."""
    return np.asarray(
        _fine_hist_fn_2d(mesh, host_axis, chip_axis, fbits, first_bit)(keys))


def plan_heavy_split(
    r_keys, s_keys, mesh: Mesh, axis: str, num_buckets: int,
    first_bit: int = 0, extra_bits: int = 6, heavy_fraction: float = 0.25,
    max_heavy: int = 128, segments: int = 1,
) -> HeavySplitPlan:
    """Plan the PRPD heavy-split exchange from one fine-histogram pre-pass
    per side.

    A fine bucket (destination bits + extra_bits more) is HEAVY when its
    global S row count exceeds heavy_fraction x the uniform per-chip share
    (n_s / ndev) — i.e. it alone would claim a meaningful fraction of one
    chip. Detection reuses heavy_destinations() with the threshold mapped
    onto its mean-relative factor. At most max_heavy buckets split (largest
    first); ties toward fewer splits.

    Caps are exact: cap_r / cap_s cover the normal exchange with heavy rows
    excluded; cap_rh covers the largest per-chip heavy R residue.
    """
    nd = mesh.shape[axis]
    assert num_buckets == nd, (
        "plan_heavy_split plans the chip-destination exchange: num_buckets "
        f"must equal the mesh size ({num_buckets} != {nd})")
    dbits = (nd - 1).bit_length()
    fbits = min(dbits + extra_bits, 22)
    nfine = 1 << fbits
    hist_s = fine_histograms(s_keys, mesh, axis, fbits, first_bit,
                             segments)                    # [nd, seg, nfine]
    hist_r = fine_histograms(r_keys, mesh, axis, fbits, first_bit, 1)
    tot_s = hist_s.sum(axis=(0, 1))                       # [nfine]
    n_s = int(tot_s.sum())
    # heavy_fraction * n_s / nd, expressed as a factor of the per-fine-
    # bucket mean (n_s / nfine) for heavy_destinations:
    factor = heavy_fraction * nfine / nd
    heavy = heavy_destinations(hist_s.sum(axis=1), factor)
    if len(heavy) > max_heavy:
        heavy = heavy[np.argsort(tot_s[heavy])[::-1][:max_heavy]]
        heavy = np.sort(heavy)
    mask = np.ones(nfine, bool)
    mask[heavy] = False
    # destination of fine bucket f is its low dbits (nd is a power of two)
    m3 = mask.reshape(-1, nd) if nd > 1 else mask.reshape(-1, 1)
    hs = hist_s.reshape(hist_s.shape[0], segments, -1, nd if nd > 1 else 1)
    hr = hist_r.reshape(hist_r.shape[0], 1, -1, nd if nd > 1 else 1)
    norm_s = (hs * m3[None, None]).sum(axis=2)            # [nd, seg, nd]
    norm_r = (hr * m3[None, None]).sum(axis=2)            # [nd, 1, nd]
    cap_s = max(_BLK, _round_up(norm_s.max(), _BLK))
    cap_r = max(_BLK, _round_up(norm_r.max(), _BLK))
    heavy_r_per_chip = hist_r[:, 0][:, ~mask].sum(axis=1) if len(heavy) \
        else np.zeros(hist_r.shape[0], np.int64)
    cap_rh = max(_BLK, _round_up(heavy_r_per_chip.max(), _BLK)) \
        if len(heavy) else _BLK
    # projected probe-row load per chip: normal S received + heavy S kept
    # local (+ the R broadcast, identical everywhere — excluded from spread)
    recv_s = norm_s.sum(axis=(0, 1))                      # [nd] received
    local_heavy_s = hist_s.sum(axis=1)[:, ~mask].sum(axis=1)
    load = recv_s + local_heavy_s
    return HeavySplitPlan(tuple(int(h) for h in np.asarray(heavy)), fbits,
                          cap_r, cap_s, cap_rh, load.astype(np.int64))


class HeavySplit2LevelPlan:
    """Static PRPD plan for the two-level (DCN x ICI) exchange: heavy fine
    buckets + exact per-level caps with heavy rows excluded (host-computed,
    hashable — feeds jit static args)."""

    def __init__(self, heavy_ids: Tuple[int, ...], fbits: int,
                 cap_r_h: int, cap_s_h: int, cap_r_c: int, cap_s_c: int,
                 cap_rh: int, load_rows: np.ndarray):
        self.heavy_ids = tuple(int(h) for h in heavy_ids)
        self.fbits = int(fbits)
        self.cap_r_h = int(cap_r_h)  # level-1 (host) R bucket cap
        self.cap_s_h = int(cap_s_h)  # level-1 (host) S bucket cap
        self.cap_r_c = int(cap_r_c)  # level-2 (chip) R bucket cap
        self.cap_s_c = int(cap_s_c)  # level-2 (chip) S bucket cap
        self.cap_rh = int(cap_rh)    # per-chip heavy-R broadcast frame rows
        self.load_rows = load_rows   # [nh*nc] projected probe rows per chip

    @property
    def split(self) -> bool:
        return len(self.heavy_ids) > 0


def plan_heavy_split_2level(
    r_keys, s_keys, mesh: Mesh, host_axis: str, chip_axis: str,
    first_bit: int = 0, extra_bits: int = 6, heavy_fraction: float = 0.25,
    max_heavy: int = 128,
) -> HeavySplit2LevelPlan:
    """PRPD heavy-split plan for the two-level exchange (the skew analog of
    plan_heavy_split for the DCN x ICI topology; reference:
    decompose_chains applies to every strategy,
    src/join-primitives.cu:843-874).

    Fine-bucket id layout (dbits = hbits + cbits destination bits at
    first_bit, extra_bits more above): f = h + (c << hbits) + (rest <<
    dbits) — host bits low, matching _two_level_local's level split. A
    fine bucket is HEAVY when its global S count exceeds heavy_fraction x
    the uniform per-chip share. Caps are exact with heavy rows excluded at
    level 1 (they never enter either exchange level).
    """
    nh, nc = mesh.shape[host_axis], mesh.shape[chip_axis]
    nd = nh * nc
    hbits = (nh - 1).bit_length()
    cbits = (nc - 1).bit_length()
    assert nh == 1 << hbits and nc == 1 << cbits, "mesh axes must be 2^k"
    dbits = hbits + cbits
    fbits = min(dbits + extra_bits, 22)
    nfine = 1 << fbits
    nrest = nfine >> dbits
    hist_s = fine_histograms_2d(s_keys, mesh, host_axis, chip_axis, fbits,
                                first_bit)                  # [nd, nfine]
    hist_r = fine_histograms_2d(r_keys, mesh, host_axis, chip_axis, fbits,
                                first_bit)
    tot_s = hist_s.sum(axis=0)
    factor = heavy_fraction * nfine / nd
    heavy = heavy_destinations(hist_s, factor)
    if len(heavy) > max_heavy:
        heavy = heavy[np.argsort(tot_s[heavy])[::-1][:max_heavy]]
        heavy = np.sort(heavy)
    mask = np.ones(nfine, bool)
    mask[heavy] = False
    # decompose: hist[src, f] with f = rest*(nc*nh) + c*nh + h
    m5 = mask.reshape(1, 1, nrest, nc, nh)
    hs = hist_s.reshape(nh, nc, nrest, nc, nh) * m5   # [h0, c0, rest, c, h]
    hr = hist_r.reshape(nh, nc, nrest, nc, nh) * m5
    # level 1: rows from source (h0, c0) to host h
    cap_s_h = max(_BLK, _round_up(hs.sum(axis=(2, 3)).max(), _BLK))
    cap_r_h = max(_BLK, _round_up(hr.sum(axis=(2, 3)).max(), _BLK))
    # level 2: source chip (h, c0) holds sum over h0 of rows to host h from
    # column c0; per level-2 destination chip c
    cap_s_c = max(_BLK, _round_up(hs.sum(axis=(0, 2)).max(), _BLK))
    cap_r_c = max(_BLK, _round_up(hr.sum(axis=(0, 2)).max(), _BLK))
    heavy_r_per_chip = hist_r[:, ~mask].sum(axis=1) if len(heavy) \
        else np.zeros(nd, np.int64)
    cap_rh = max(_BLK, _round_up(heavy_r_per_chip.max(), _BLK)) \
        if len(heavy) else _BLK
    # projected probe load per destination chip (h, c): normal S received
    # + heavy S kept local at that mesh position
    recv_ch = hs.sum(axis=(0, 1, 2))                  # [c, h]
    recv = recv_ch.T.reshape(-1)                      # [nd] host-major
    local_heavy_s = hist_s[:, ~mask].sum(axis=1)      # [nd] host-major
    load = recv + local_heavy_s
    return HeavySplit2LevelPlan(
        tuple(int(h) for h in np.asarray(heavy)), fbits,
        cap_r_h, cap_s_h, cap_r_c, cap_s_c, cap_rh, load.astype(np.int64))
