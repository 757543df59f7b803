"""Histogram -> scan -> block-scatter radix partitioning (a prototype of
the reference's partition_pass_one/_two, src/join-primitives.cu:58-283,
338-535, without scatter).

The per-tile "binning" step is realized as a CHUNK-LOCAL SORT, followed by
exact histogram metadata and ONE dense 128-row-block gather into
partition-contiguous layout:

  1. reshape to [C, L] chunks, lax.sort each chunk (partition id rides the
     top bits of the unsigned key view, so chunk-sorting groups runs);
  2. per-chunk histograms [C, P] via one-hot compare-reduce -> exact run
     starts within each chunk;
  3. destination block table: every (chunk, partition) run padded to
     128-row blocks (partition-major exclusive scan over block counts);
  4. one block-level jnp.take moves everything; rows outside a run's
     [lo, hi) inside boundary blocks are masked to sentinels.

Output: partition-grouped columns with per-partition VALID counts and
padded CSR offsets (buckets of 128, the analog of the reference's 4096-row
bucket chains — padding instead of chaining).

Verdict where it was first measured (not re-measured on the GPU; ROADMAP
Dx2): as a FULL SORT accelerator this loses to jax.lax.sort — each radix
level needs a chunk sort (>= half of a flat sort's comparison levels) and
the final within-partition segmented sort of n/P-sized segments is slower
than flat sort at any reachable P. It WINS as a grouping-only primitive (few bits,
no within-partition order needed): the distributed exchange's
partition-by-destination-chip is exactly that shape.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

_BLK = 128


class GroupedColumns(NamedTuple):
    keys: jnp.ndarray          # [n_padded] partition-grouped, 128-padded
    pays: jnp.ndarray          # [n_padded]
    counts: jnp.ndarray        # [P] valid rows per partition
    block_offsets: jnp.ndarray  # [P+1] block offsets of each partition's run
    # valid rows of partition p: the first counts[p] non-sentinel rows in
    # blocks [block_offsets[p], block_offsets[p+1]) (sentinels interleave at
    # chunk-run boundaries; key sentinel 0x7FFFFFFF, payload 0)


def _unsigned_view(keys: jnp.ndarray) -> jnp.ndarray:
    """Map signed int32 to the same order as unsigned (flip sign bit); lets
    partition ids ride the top bits while lax.sort compares signed."""
    return keys ^ jnp.int32(-0x80000000)


@functools.partial(jax.jit, static_argnames=("bits", "chunk", "cap_blocks"))
def radix_group(keys, pays, bits: int, chunk: int = 4096,
                cap_blocks: int | None = None) -> GroupedColumns:
    """Group rows by partition id = top `bits` of the unsigned key view.

    Rows inside a partition keep no particular order (grouping only — the
    fast case). Pad/garbage rows carry key sentinel 0x7FFFFFFF, payload 0.
    """
    n = keys.shape[0]
    P = 1 << bits
    assert chunk % _BLK == 0, "chunk must be a 128 multiple"
    L = min(chunk, -(-max(n, 1) // _BLK) * _BLK)
    C = -(-n // L)
    pad = C * L - n
    SENT = jnp.int32(0x7FFFFFFF)
    if pad:
        keys = jnp.concatenate([keys, jnp.full((pad,), SENT, jnp.int32)])
        pays = jnp.concatenate([pays, jnp.zeros((pad,), jnp.int32)])

    # 1. chunk-local sort (sorting by key groups by pid: pid is a prefix
    # of the key's order bits)
    k2 = keys.reshape(C, L)
    v2 = pays.reshape(C, L)
    k2, v2 = jax.lax.sort((k2, v2), num_keys=1, dimension=1, is_stable=False)

    u = _unsigned_view(k2)
    shift = 32 - bits
    # pid in [0, P); sentinel rows land in the top partition (counted out
    # via the valid-count bookkeeping below)
    pid = jax.lax.shift_right_logical(u, jnp.int32(shift)).astype(jnp.int32)

    # 2. per-chunk histograms + run starts
    oh = (pid[:, :, None] == jnp.arange(P, dtype=jnp.int32)[None, None, :])
    hist = jnp.sum(oh.astype(jnp.int32), axis=1)              # [C, P]
    starts = jnp.cumsum(hist, axis=1) - hist                  # [C, P]

    # exclude sentinel pad rows from the LAST partition's count of the
    # last chunk (they sorted to its very end)
    valid_hist = hist
    if pad:
        valid_hist = hist.at[C - 1, P - 1].add(-pad)

    # 3. destination block table, partition-major
    g0 = starts + jnp.arange(C, dtype=jnp.int32)[:, None] * L   # [C, P] global row
    run_lo = g0 % _BLK
    blk0 = g0 // _BLK
    nblk = jnp.where(hist > 0, (g0 + hist - 1) // _BLK - blk0 + 1, 0)  # [C, P]
    nblk_pm = nblk.T.reshape(-1)                              # [P*C] p-major
    cum = jnp.cumsum(nblk_pm) - nblk_pm                       # dest block of run
    total_blocks = jnp.sum(nblk_pm)

    if cap_blocks is None:
        cap_blocks = (C * L) // _BLK + C * P
    run_id = jnp.repeat(jnp.arange(C * P, dtype=jnp.int32), nblk_pm,
                        total_repeat_length=cap_blocks)        # p-major run
    run_start_blk = jnp.repeat(cum.astype(jnp.int32), nblk_pm,
                               total_repeat_length=cap_blocks)
    bpos = jnp.arange(cap_blocks, dtype=jnp.int32) - run_start_blk  # k within run

    # p-major run r = (p, c): c = r % C
    run_c = run_id % C
    src_blk = jnp.take(blk0.T.reshape(-1), run_id) + bpos
    lo = jnp.take(run_lo.T.reshape(-1), run_id)
    hi = lo + jnp.take(hist.T.reshape(-1), run_id)
    in_range = jnp.arange(cap_blocks) < total_blocks

    # 4. block gather + boundary masking
    kb = k2.reshape(-1, _BLK)
    vb = v2.reshape(-1, _BLK)
    src_blk = jnp.where(in_range, src_blk, 0)
    gk = jnp.take(kb, src_blk, axis=0)                        # [cap, 128]
    gv = jnp.take(vb, src_blk, axis=0)
    row = jax.lax.broadcasted_iota(jnp.int32, (cap_blocks, _BLK), 1)
    abs_row = bpos[:, None] * _BLK + row
    valid = ((abs_row >= lo[:, None]) & (abs_row < hi[:, None])
             & in_range[:, None])
    gk = jnp.where(valid, gk, SENT)
    gv = jnp.where(valid, gv, 0)

    counts = jnp.sum(valid_hist, axis=0)
    pblocks = jnp.sum(nblk, axis=0)                           # [P]
    block_offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(pblocks).astype(jnp.int32)])
    return GroupedColumns(gk.reshape(-1), gv.reshape(-1),
                          counts.astype(jnp.int32), block_offsets)


def grouped_block_counts(keys: jnp.ndarray, bits: int,
                         chunk: int = 4096) -> jnp.ndarray:
    """[P] int32: exactly how many destination blocks radix_group(keys,
    ..., bits, chunk) will lay out per partition (same C/L geometry, same
    per-(chunk, partition) boundary-block padding, same sentinel-pad
    accounting). Needs only histograms — no sort, no data movement — so
    an exchange planner can derive exact grouped-frame caps in a cheap
    pre-pass (parallel/plan.plan_cap_grouped)."""
    n = keys.shape[0]
    P = 1 << bits
    L = min(chunk, -(-max(n, 1) // _BLK) * _BLK)
    C = -(-n // L)
    pad = C * L - n
    u = _unsigned_view(keys)
    pid = jax.lax.shift_right_logical(u, jnp.int32(32 - bits)).astype(
        jnp.int32)
    if pad:
        pid = jnp.concatenate(
            [pid, jnp.full((pad,), P - 1, jnp.int32)])  # sentinels -> P-1
    pid2 = pid.reshape(C, L)
    oh = (pid2[:, :, None] == jnp.arange(P, dtype=jnp.int32)[None, None, :])
    hist = jnp.sum(oh.astype(jnp.int32), axis=1)              # [C, P]
    starts = jnp.cumsum(hist, axis=1) - hist
    g0 = starts + jnp.arange(C, dtype=jnp.int32)[:, None] * L
    nblk = jnp.where(hist > 0, (g0 + hist - 1) // _BLK - g0 // _BLK + 1, 0)
    return jnp.sum(nblk, axis=0).astype(jnp.int32)


@functools.partial(jax.jit,
                   static_argnames=("bits", "chunk", "lmax_blocks"))
def radix_sort_via_grouping(keys, pays, bits: int = 5, chunk: int = 4096,
                            lmax_blocks: int | None = None):
    """FULL sort via one radix-group level + per-partition segmented sort.

    The prototype behind the 'radix vs flat sort' decision (see module
    docstring). Every partition is slotted into a static
    [P, lmax_blocks*128] frame so the final sort batches; `overflow` > 0
    means a partition outgrew the frame (skewed input — callers must
    re-plan with a larger frame; the engine does not use this path for
    sorting, it exists to close the question with measurements).

    Returns (keys_sorted_padded [P, lmax*128], pays_sorted_padded,
    n_valid_total, overflow_blocks). Sentinel rows (key 0x7FFFFFFF,
    payload 0) sort to each segment's tail.
    """
    g = radix_group(keys, pays, bits, chunk)
    P = 1 << bits
    nb = g.keys.shape[0] // _BLK
    if lmax_blocks is None:
        # 2x uniform expectation over the partitions actually REACHABLE by
        # non-negative keys (the sign-bit flip of _unsigned_view maps them
        # all to pids >= P/2, so only P/2 partitions fill), plus one
        # boundary block per (chunk, partition) run of those partitions.
        C = -(-keys.shape[0] // chunk)
        lmax_blocks = max(2 * nb // max(P // 2, 1) + C + 16, 1)
    pb = g.block_offsets[1:] - g.block_offsets[:-1]
    overflow = jnp.sum(jnp.maximum(pb - lmax_blocks, 0))
    jidx = jax.lax.broadcasted_iota(jnp.int32, (P, lmax_blocks), 1)
    src = g.block_offsets[:-1][:, None] + jidx
    ok = jidx < pb[:, None]
    src = jnp.where(ok, src, 0)
    kb = jnp.take(g.keys.reshape(-1, _BLK), src.reshape(-1), axis=0)
    vb = jnp.take(g.pays.reshape(-1, _BLK), src.reshape(-1), axis=0)
    SENT = jnp.int32(0x7FFFFFFF)
    okr = ok.reshape(-1)[:, None]
    kb = jnp.where(okr, kb, SENT)
    vb = jnp.where(okr, vb, 0)
    ks = kb.reshape(P, lmax_blocks * _BLK)
    vs = vb.reshape(P, lmax_blocks * _BLK)
    ks, vs = jax.lax.sort((ks, vs), num_keys=1, dimension=1, is_stable=False)
    return ks, vs, jnp.sum(g.counts), overflow
