"""Banded sort-merge probe over sorted relations (the engine's hot path).

Replaces the shared-memory hash-table probe of the reference
(join_partitioned_aggregate / join_partitioned_results,
src/join-primitives.cu:885-1416) with a formulation that needs no scatter
and no atomics: all data-dependent movement is 128-row block gathers, and
the matching is dense broadcast-compare-reduce. Whether that trade beats a
scatter/atomic hash probe on the GPU is not measured yet (PERF.md, open
questions).

Both relations are sorted by the rotated key (exactly the layout
ops/partition.radix_partition already produces — partition grouping IS a
sort prefix), so the join is a merge with block-level alignment:

  1. block summaries: bmin/bmax of every 128-row block;
  2. for each S block, its exact matching R-block window
     [lo, hi) = [rank(r_bmax < s_bmin), rank(r_bmin <= s_bmax)) — ranks of
     sorted probes in a sorted array, computed with ONE small (val, tag)
     sort over the block summaries instead of per-probe binary searches;
  3. per round r: row-gather W R-blocks at lo + r*W and fused
     compare x multiply x accumulate against the S block;
     rounds loop until max(ceil((hi-lo)/W)) — a traced while bound, so
     skew (duplicate-heavy keys widen windows) costs work proportional to
     the true blow-up, the decompose_chains analog
     (src/join-primitives.cu:843-874).

The per-chunk compare/select steps are four small plain-jnp helpers
(banded_compare_sum, banded_compare_per_s, banded_compare_first,
banded_interval_select); XLA fuses each broadcast-compare-reduce into
reduction kernels. On a GPU the aggregate probe's chunk step runs a
hand-written Triton kernel instead (ops/band_compare_triton.py).

Everything is jittable end to end: no host-side planning phase at all.

Aggregate semantics match the reference exactly: SUM(Pr*Ps) accumulated in
int32 with wraparound (src/join-primitives.cu:1052-1092).
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import jax
import jax.numpy as jnp

from icde2019_gpu_join.ops.bits import rotate_keys
from icde2019_gpu_join.ops.sort import packed_sort_pairs

_BLK = 128

# Engine-wide sort implementation for the two hot (sortval, payload) sorts:
# "lax" = XLA's flat unstable 2-operand sort (the default),
# "packed" = 1-operand uint64 pack sort (ops.sort.packed_sort_pairs).
SORT_IMPLS = ("lax", "packed")
_SORT_IMPL = os.environ.get("JOIN_SORT_IMPL", "lax")


def set_sort_impl(name: str) -> None:
    """Set the process-default hot-path sort ("lax" | "packed").

    The impl is threaded as a REAL jit static argument through every
    entry point: public wrappers resolve `sort_impl or _SORT_IMPL` before
    entering jit, so each impl owns its own compile-cache entries,
    flipping the default never leaves a stale trace behind, and two
    engines with different `EngineConfig.sort_impl` coexist in one process
    without cache clearing."""
    global _SORT_IMPL
    _SORT_IMPL = resolve_sort_impl(name)


def get_sort_impl() -> str:
    """The process-default hot-path sort implementation."""
    return _SORT_IMPL


def resolve_sort_impl(sort_impl) -> str:
    """Resolve an optional per-call impl against the process default —
    call OUTSIDE jit so the result feeds a static argument."""
    impl = sort_impl or _SORT_IMPL
    if impl not in SORT_IMPLS:
        raise ValueError(
            f"unknown sort_impl {impl!r}: expected one of {SORT_IMPLS}")
    return impl


def _pad_sorted_input(keys: jnp.ndarray, pay: jnp.ndarray):
    """Pad to a 128 multiple (at least one block: empty relations become a
    pure-sentinel block) with sentinel rows (key -1 -> max sortval,
    payload 0: sorts to the end, contributes 0 to any aggregate)."""
    n = keys.shape[0]
    pad = (-n) % _BLK if n else _BLK
    if pad:
        keys = jnp.concatenate([keys, jnp.full((pad,), -1, jnp.int32)])
        pay = jnp.concatenate([pay, jnp.zeros((pad,), jnp.int32)])
    return keys, pay


def sort_pairs(sv: jnp.ndarray, pay: jnp.ndarray, sort_impl: str = None):
    """The engine's hot 2-operand (sortval, payload) sort. Signed-int32
    ascending, unstable — both impls agree on the key order and the
    per-key payload multiset.

    sort_impl: "lax" | "packed" | None (= process default).
    Callers inside jit must receive it as a static argument — the choice
    is resolved at trace time."""
    if resolve_sort_impl(sort_impl) == "packed":
        return packed_sort_pairs(sv, pay)
    return jax.lax.sort((sv, pay), num_keys=1, is_stable=False)


def sort_by_key(keys: jnp.ndarray, pay: jnp.ndarray, sort_impl: str = None):
    """Sort (keys, pay) by uint32 key order; returns 128-padded arrays.

    The same order radix_partition produces (rotation with total_bits=0 is
    the plain sign-flip), so partitioned relations can be consumed directly.
    """
    keys, pay = _pad_sorted_input(keys, pay)
    sv = rotate_keys(keys, 0, 0)
    return sort_pairs(sv, pay, sort_impl)


def _ranks_of_sorted_probes(a: jnp.ndarray, b: jnp.ndarray, a_first_on_ties: bool):
    """For each b[i] (b sorted ascending): number of a-elements that sort
    before it, with ties broken toward a if a_first_on_ties (i.e. returns
    # {a <= b[i]}) else toward b (# {a < b[i]}). One (val, tag, idx) sort.
    """
    na, nb = a.shape[0], b.shape[0]
    assert na < (1 << 30) and nb < (1 << 30)
    vals = jnp.concatenate([a, b])
    # pack (tie-tag, origin index) into ONE int32 second sort key: a
    # 2-operand sort instead of the 3-operand (vals, tags, idx) variant
    tag_a, tag_b = (0, 1) if a_first_on_ties else (1, 0)
    packed = jnp.concatenate([
        (jnp.int32(tag_a) << 30) | jnp.arange(na, dtype=jnp.int32),
        (jnp.int32(tag_b) << 30) | jnp.arange(1, nb + 1, dtype=jnp.int32),
    ])
    _, packed_s = jax.lax.sort((vals, packed), num_keys=2, is_stable=False)
    is_b_tag = 1 if tag_b else 0
    tags_s = (packed_s >> 30) & 1
    idx_s = packed_s & ((1 << 30) - 1)
    is_b = tags_s == is_b_tag
    # a-count strictly before each merged position
    pos = jnp.arange(na + nb, dtype=jnp.int32)
    b_before = jnp.cumsum(is_b.astype(jnp.int32)) - is_b.astype(jnp.int32)
    a_before = pos - b_before
    ranks = jnp.zeros((nb,), jnp.int32).at[
        jnp.where(is_b, idx_s - 1, nb)
    ].set(a_before, mode="drop")
    return ranks


def block_windows(r_sv: jnp.ndarray, s_sv: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact matching R-block window [lo, hi) for every 128-row S block.

    R block j can contain a match for S block b iff
    r_bmax[j] >= s_bmin[b] and r_bmin[j] <= s_bmax[b].

    Ranks come from the (val, packed-tag) merge-sort trick
    (_ranks_of_sorted_probes) rather than jnp.searchsorted's element-gather
    binary search; which is faster on the GPU is not measured yet. Summaries
    use contiguous axis-1 reductions (the relation is sorted, so min/max
    are also the block's first/last element).
    """
    r2 = r_sv.reshape(-1, _BLK)
    s2 = s_sv.reshape(-1, _BLK)
    r_bmin = jnp.min(r2, axis=1)
    r_bmax = jnp.max(r2, axis=1)
    s_bmin = jnp.min(s2, axis=1)
    s_bmax = jnp.max(s2, axis=1)
    # lo = # of R blocks with bmax < s_bmin  (ties: keep block -> a after b)
    lo = _ranks_of_sorted_probes(r_bmax, s_bmin, a_first_on_ties=False)
    # hi = # of R blocks with bmin <= s_bmax (ties: include block -> a first)
    hi = _ranks_of_sorted_probes(r_bmin, s_bmax, a_first_on_ties=True)
    return lo, jnp.maximum(hi, lo)


# S blocks processed per inner chunk (static shape; 2048 blocks = 256K rows)
_CHUNK_BLOCKS = 2048


# ---- per-chunk compare/select helpers ------------------------------------
# Each compares a [CH, 128] S tile with a [CH, W*128] gathered R window and
# reduces over the window. All arithmetic is 32-bit with wraparound, so the
# results are bit-identical to the reference's uint32 semantics. The named
# scopes let a profiler trace attribute the fused kernels to each helper.


@jax.named_scope("banded_compare_sum")
def banded_compare_sum(sk, sp, rk, rp):
    """SUM over (i, l, j) of [sk[i,l] == rk[i,j]] * sp[i,l] * rp[i,j],
    mod 2^32, as a uint32 scalar.

    sk/sp: [CH, 128] int32; rk/rp: [CH, W*128] int32. Window rows that are
    not part of a window must carry rp == 0."""
    eq = sk[:, :, None] == rk[:, None, :]
    per_s = jnp.sum(
        jnp.where(eq, rp.astype(jnp.uint32)[:, None, :], jnp.uint32(0)),
        axis=2, dtype=jnp.uint32)
    return jnp.sum(per_s * sp.astype(jnp.uint32), dtype=jnp.uint32)


@jax.named_scope("banded_compare_per_s")
def banded_compare_per_s(sk, rk, rp):
    """Per-S-element (match count h, matched-R-payload sum t), both
    [CH, 128] int32 (t wraps). Window rows that are not part of a window
    must carry rp == 0 AND a key that cannot match (the R-pad sentinel)."""
    eq = sk[:, :, None] == rk[:, None, :]
    h = jnp.sum(eq.astype(jnp.int32), axis=2)
    t = jnp.sum(jnp.where(eq, rp[:, None, :], 0), axis=2)
    return h, t


@jax.named_scope("banded_compare_first")
def banded_compare_first(sk, rk, gidx):
    """Per-S-element (match count h, FIRST matching global R index fm),
    [CH, 128] int32; fm = INT32_MAX where there is no match. gidx carries
    the global sorted-R row index of every window column. Matches of one S
    element are contiguous in sorted R order, so (fm, h) describes its
    whole match set."""
    eq = sk[:, :, None] == rk[:, None, :]
    h = jnp.sum(eq.astype(jnp.int32), axis=2)
    fm = jnp.min(jnp.where(eq, gidx[:, None, :], jnp.int32(0x7FFFFFFF)),
                 axis=2)
    return h, fm


@jax.named_scope("banded_interval_select")
def banded_interval_select(pos, lo, hi, p1, p2, p3):
    """For each slot (i, l): the payload triple of the window column j with
    lo[i,j] <= pos[i,l] < hi[i,j] (0s when none). pos: [CH, 128]; the rest
    [CH, WB] int32. Intervals within a row must be disjoint."""
    inb = (lo[:, None, :] <= pos[:, :, None]) & (pos[:, :, None] < hi[:, None, :])

    def sel(p):
        return jnp.sum(jnp.where(inb, p[:, None, :], 0), axis=2)

    return sel(p1), sel(p2), sel(p3)


def _window_blocks_of(base, his, active, window_blocks: int, nrb: int):
    """R-block ids of each S block's current window slice and its row mask:
    bidx [CH*W] (clamped in range), vmask [CH, W*128]."""
    warr = jnp.arange(window_blocks, dtype=jnp.int32)
    bidx = base[:, None] + warr[None, :]                  # [CH, W]
    valid = (bidx < his[:, None]) & active[:, None]
    bidx = jnp.clip(bidx, 0, nrb - 1)
    return bidx.reshape(-1), jnp.repeat(valid, _BLK, axis=1)


def chunk_compare_sum(s_svb, s_payb, r_svb, r_payb, ids, base, his, active,
                      window_blocks: int):
    """One chunk of the "mul" probe as a uint32 partial sum: gather S
    blocks `ids` and the W R-blocks of each window starting at `base`
    (blocks at/after `his`, or of inactive slots, contribute 0), then
    reduce with banded_compare_sum."""
    ch = ids.shape[0]
    bidx, vmask = _window_blocks_of(base, his, active, window_blocks,
                                    r_svb.shape[0])
    sk = jnp.take(s_svb, ids, axis=0)                     # [CH, 128]
    sp = jnp.take(s_payb, ids, axis=0)
    rk = jnp.take(r_svb, bidx, axis=0).reshape(ch, -1)    # [CH, W*128]
    rp = jnp.where(vmask, jnp.take(r_payb, bidx, axis=0).reshape(ch, -1), 0)
    return banded_compare_sum(sk, sp, rk, rp)


def _chunk_sum_impl():
    """The "mul" probe's chunk step for the default backend. On a GPU it is
    the hand-written Triton kernel (ops/band_compare_triton.py), which
    fuses the window gather and measured faster end to end than XLA's
    fusion of chunk_compare_sum (docs/DESIGN_NOTES.md, GPU bring-up).
    Elsewhere it is chunk_compare_sum, which is also the kernel's
    reference."""
    if jax.default_backend() == "gpu":
        from icde2019_gpu_join.ops.band_compare_triton import (
            chunk_compare_sum_triton)
        return chunk_compare_sum_triton
    return chunk_compare_sum


@functools.partial(jax.jit, static_argnames=("window_blocks", "mode"))
def banded_probe(
    r_sv: jnp.ndarray, r_pay: jnp.ndarray,
    s_sv: jnp.ndarray, s_pay: jnp.ndarray,
    window_blocks: int = 1,
    mode: str = "mul",   # "mul": SUM(Pr*Ps); "add": SUM(Pr+Ps)
) -> jnp.ndarray:
    """Aggregate join over sv-sorted 128-padded inputs. Returns int32 scalar
    (uint32 wraparound accumulation, the reference's semantics).

    Skew-robust scheduling: S blocks are sorted by window width (descending)
    and round r processes only the prefix of blocks whose window still has
    uncovered R-blocks, in _CHUNK_BLOCKS-sized dynamic slices. Total compare
    work is proportional to the true match volume (sum of window widths),
    not max-width x all-blocks — the decompose_chains + knapsack-batching
    analog (src/join-primitives.cu:843-874, partition-primitives.cu:307-469)
    done as dense scheduling instead of work-item lists."""
    W = window_blocks
    nsb_in = s_sv.shape[0] // _BLK
    # chunk size adapts to the input so tiny relations don't pay for a full
    # 2048-block chunk per round (shapes are static at trace time)
    CH = min(_CHUNK_BLOCKS, 1 << max(3, (nsb_in - 1).bit_length()))
    nrb = r_sv.shape[0] // _BLK
    lo, hi = block_windows(r_sv, s_sv)
    nrounds = (hi - lo + (W - 1)) // W

    nsb = s_sv.shape[0] // _BLK
    bid = jnp.arange(nsb, dtype=jnp.int32)
    # 2-operand descriptor sort; lo/hi are gathered per chunk by block id
    neg_rounds, bid_s = jax.lax.sort((-nrounds, bid), num_keys=1,
                                     is_stable=False)
    rounds_s = -neg_rounds  # descending

    # pad descriptor arrays to a CH multiple so dynamic slices stay in bounds
    pad = (-nsb) % CH
    if pad:
        z = jnp.zeros((pad,), jnp.int32)
        rounds_s = jnp.concatenate([rounds_s, z])
        bid_s = jnp.concatenate([bid_s, z])

    r_svb = r_sv.reshape(-1, _BLK)
    r_payb = r_pay.reshape(-1, _BLK)
    s_svb = s_sv.reshape(-1, _BLK)
    s_payb = s_pay.reshape(-1, _BLK)

    def chunk_contrib(r, c, cnt):
        start = c * CH
        ids = jax.lax.dynamic_slice(bid_s, (start,), (CH,))
        ids = jnp.clip(ids, 0, nsb - 1)
        base = jnp.take(lo, ids) + r * W
        his = jnp.take(hi, ids)
        active = (start + jnp.arange(CH, dtype=jnp.int32)) < cnt
        if mode == "mul":
            return _chunk_sum_impl()(s_svb, s_payb, r_svb, r_payb, ids, base,
                                     his, active, window_blocks=W)
        bidx, vmask = _window_blocks_of(base, his, active, W, nrb)
        sk = jnp.take(s_svb, ids, axis=0)
        sp = jnp.take(s_payb, ids, axis=0).astype(jnp.uint32)
        rk = jnp.take(r_svb, bidx, axis=0).reshape(CH, W * _BLK)
        rp = jnp.take(r_payb, bidx, axis=0).reshape(CH, W * _BLK).astype(
            jnp.uint32)
        eq = (sk[:, :, None] == rk[:, None, :]) & vmask[:, None, :]
        both = sp[:, :, None] + rp[:, None, :]
        return jnp.sum(jnp.where(eq, both, jnp.uint32(0)), dtype=jnp.uint32)

    def round_body(state):
        r, acc = state
        cnt = jnp.sum((rounds_s > r).astype(jnp.int32))  # active prefix len
        nch = (cnt + CH - 1) // CH

        def inner(c, acc):
            return acc + chunk_contrib(r, c, cnt)

        acc = jax.lax.fori_loop(0, nch, inner, acc)
        return r + 1, acc

    def round_cond(state):
        r, _ = state
        return jnp.sum((rounds_s > r).astype(jnp.int32)) > 0

    # Initial carries derived from the (possibly shard_map-varying) inputs so
    # the loop carry types match inside manual-sharding regions.
    acc0 = (rounds_s[0] * 0).astype(jnp.uint32)
    r0 = rounds_s[0] * 0
    _, total = jax.lax.while_loop(round_cond, round_body, (r0, acc0))
    return total.astype(jnp.int32)


_R_PAD_SV = 0x7FFFFFFF  # sv of key -1 (R-side pad); never matches real keys


@functools.partial(jax.jit, static_argnames=("window_blocks",))
def banded_probe_per_s(
    r_sv: jnp.ndarray, r_pay: jnp.ndarray, s_sv: jnp.ndarray,
    window_blocks: int = 1,
):
    """Per-S-element probe: returns (h, t) int32 arrays aligned with the
    *given sorted S order* — h[i] = number of R matches of S row i, t[i] =
    SUM of matched R payloads (int32 wraparound). The building block for
    fused probe->group-by pipelines and materialization counting (phase 1 of
    join_partitioned_results, src/join-primitives.cu:1107-1416).

    Requires real keys >= 0 (sentinels occupy sv 0x7FFFFFFE/0x7FFFFFFF)."""
    W = window_blocks
    nsb = s_sv.shape[0] // _BLK
    CH = min(_CHUNK_BLOCKS, 1 << max(3, (nsb - 1).bit_length()))
    nrb = r_sv.shape[0] // _BLK
    lo, hi = block_windows(r_sv, s_sv)
    nrounds = (hi - lo + (W - 1)) // W

    bid = jnp.arange(nsb, dtype=jnp.int32)
    neg_rounds, bid_s = jax.lax.sort((-nrounds, bid), num_keys=1,
                                     is_stable=False)
    rounds_s = -neg_rounds
    pad = (-nsb) % CH
    if pad:
        z = jnp.zeros((pad,), jnp.int32)
        rounds_s = jnp.concatenate([rounds_s, z])
        # distinct out-of-range pad block ids so the inverse permutation
        # scatter below never collides with real blocks
        bid_s = jnp.concatenate([
            bid_s, nsb + jnp.arange(pad, dtype=jnp.int32)
        ])

    r_svb = r_sv.reshape(-1, _BLK)
    r_payb = r_pay.reshape(-1, _BLK)
    s_svb = s_sv.reshape(-1, _BLK)
    warr = jnp.arange(W, dtype=jnp.int32)

    # carries derived from the inputs so their types match the loop body
    # inside shard_map regions (varying manual axes)
    r0 = rounds_s[0] * 0
    h0 = jnp.zeros((nsb + pad, _BLK), jnp.int32) + r0
    t0 = h0

    def chunk(r, c, cnt, h_acc, t_acc):
        start = c * CH
        ids = jax.lax.dynamic_slice(bid_s, (start,), (CH,))
        idc = jnp.clip(ids, 0, nsb - 1)
        los = jnp.take(lo, idc)
        his = jnp.take(hi, idc)
        active = (start + jnp.arange(CH, dtype=jnp.int32)) < cnt
        sk = jnp.take(s_svb, idc, axis=0)
        base = los + r * W
        bidx = base[:, None] + warr[None, :]
        valid = (bidx < his[:, None]) & active[:, None]
        bidx = jnp.clip(bidx, 0, nrb - 1)
        rk = jnp.take(r_svb, bidx.reshape(-1), axis=0).reshape(CH, W * _BLK)
        rp = jnp.take(r_payb, bidx.reshape(-1), axis=0).reshape(CH, W * _BLK)
        vmask = jnp.repeat(valid, _BLK, axis=1)
        rk = jnp.where(vmask, rk, _R_PAD_SV)   # unmatched sentinel
        rp = jnp.where(vmask, rp, 0)
        hch, tch = banded_compare_per_s(sk, rk, rp)
        # accumulate into the sorted-block positions (multi-round +=)
        hs = jax.lax.dynamic_slice(h_acc, (start, 0), (CH, _BLK))
        ts = jax.lax.dynamic_slice(t_acc, (start, 0), (CH, _BLK))
        h_acc = jax.lax.dynamic_update_slice(h_acc, hs + hch, (start, 0))
        t_acc = jax.lax.dynamic_update_slice(t_acc, ts + tch, (start, 0))
        return h_acc, t_acc

    def round_body(state):
        r, h_acc, t_acc = state
        cnt = jnp.sum((rounds_s > r).astype(jnp.int32))
        nch = (cnt + CH - 1) // CH

        def inner(c, acc):
            return chunk(r, c, cnt, *acc)

        h_acc, t_acc = jax.lax.fori_loop(0, nch, inner, (h_acc, t_acc))
        return r + 1, h_acc, t_acc

    def round_cond(state):
        return jnp.sum((rounds_s > state[0]).astype(jnp.int32)) > 0

    _, h_sorted, t_sorted = jax.lax.while_loop(
        round_cond, round_body, (r0, h0, t0)
    )
    # un-permute from width-sorted block order back to sorted-S block order
    inv = jnp.zeros((nsb + pad,), jnp.int32).at[bid_s].set(
        jnp.arange(nsb + pad, dtype=jnp.int32), mode="drop")
    h = jnp.take(h_sorted, inv[:nsb], axis=0).reshape(-1)
    t = jnp.take(t_sorted, inv[:nsb], axis=0).reshape(-1)
    return h, t


@functools.partial(jax.jit, static_argnames=("window_blocks",))
def banded_match_descriptors(
    r_sv: jnp.ndarray, s_sv: jnp.ndarray,
    window_blocks: int = 1,
):
    """Per-S-element (match_count h, first-match sorted-R index fm).

    Because both sides are key-sorted, S row i's matches are exactly the
    contiguous sorted-R rows [fm[i], fm[i]+h[i]) — the dense-counting phase
    of materialization (phase 1 of join_partitioned_results,
    src/join-primitives.cu:1107-1416). fm = INT32_MAX where h == 0."""
    W = window_blocks
    nsb = s_sv.shape[0] // _BLK
    CH = min(_CHUNK_BLOCKS, 1 << max(3, (nsb - 1).bit_length()))
    nrb = r_sv.shape[0] // _BLK
    lo, hi = block_windows(r_sv, s_sv)
    nrounds = (hi - lo + (W - 1)) // W

    bid = jnp.arange(nsb, dtype=jnp.int32)
    neg_rounds, bid_s = jax.lax.sort((-nrounds, bid), num_keys=1,
                                     is_stable=False)
    rounds_s = -neg_rounds
    pad = (-nsb) % CH
    if pad:
        z = jnp.zeros((pad,), jnp.int32)
        rounds_s = jnp.concatenate([rounds_s, z])
        bid_s = jnp.concatenate([
            bid_s, nsb + jnp.arange(pad, dtype=jnp.int32)
        ])

    r_svb = r_sv.reshape(-1, _BLK)
    s_svb = s_sv.reshape(-1, _BLK)
    warr = jnp.arange(W, dtype=jnp.int32)
    big = jnp.int32(0x7FFFFFFF)

    r0 = rounds_s[0] * 0
    h0 = jnp.zeros((nsb + pad, _BLK), jnp.int32) + r0
    f0 = h0 + big

    def chunk(r, c, cnt, h_acc, f_acc):
        start = c * CH
        ids = jax.lax.dynamic_slice(bid_s, (start,), (CH,))
        idc = jnp.clip(ids, 0, nsb - 1)
        los = jnp.take(lo, idc)
        his = jnp.take(hi, idc)
        active = (start + jnp.arange(CH, dtype=jnp.int32)) < cnt
        sk = jnp.take(s_svb, idc, axis=0)
        base = los + r * W
        bidx = base[:, None] + warr[None, :]
        valid = (bidx < his[:, None]) & active[:, None]
        bidx = jnp.clip(bidx, 0, nrb - 1)
        rk = jnp.take(r_svb, bidx.reshape(-1), axis=0).reshape(CH, W * _BLK)
        vmask = jnp.repeat(valid, _BLK, axis=1)
        rk = jnp.where(vmask, rk, _R_PAD_SV)
        gidx = (jnp.repeat(bidx, _BLK, axis=1) * _BLK
                + jnp.tile(jnp.arange(_BLK, dtype=jnp.int32), (CH, W)))
        hch, fch = banded_compare_first(sk, rk, gidx)
        hs = jax.lax.dynamic_slice(h_acc, (start, 0), (CH, _BLK))
        fs = jax.lax.dynamic_slice(f_acc, (start, 0), (CH, _BLK))
        h_acc = jax.lax.dynamic_update_slice(h_acc, hs + hch, (start, 0))
        f_acc = jax.lax.dynamic_update_slice(
            f_acc, jnp.minimum(fs, fch), (start, 0))
        return h_acc, f_acc

    def round_body(state):
        r, h_acc, f_acc = state
        cnt = jnp.sum((rounds_s > r).astype(jnp.int32))
        nch = (cnt + CH - 1) // CH

        def inner(c, acc):
            return chunk(r, c, cnt, *acc)

        h_acc, f_acc = jax.lax.fori_loop(0, nch, inner, (h_acc, f_acc))
        return r + 1, h_acc, f_acc

    def round_cond(state):
        return jnp.sum((rounds_s > state[0]).astype(jnp.int32)) > 0

    _, h_sorted, f_sorted = jax.lax.while_loop(
        round_cond, round_body, (r0, h0, f0)
    )
    inv = jnp.zeros((nsb + pad,), jnp.int32).at[bid_s].set(
        jnp.arange(nsb + pad, dtype=jnp.int32), mode="drop")
    h = jnp.take(h_sorted, inv[:nsb], axis=0).reshape(-1)
    fm = jnp.take(f_sorted, inv[:nsb], axis=0).reshape(-1)
    return h, fm


def _extract_blocked(h, fm, off, s_p, r_p, capacity: int, total, s_lo,
                     rb0, swb: int = 3, rwb: int = 6):
    """Block-windowed match extraction: slots [t*128, (t+1)*128) resolve
    their owning S row and R position against per-block windows, so all
    data movement is 128-row block gathers + two windowed selects — no
    per-slot searchsorted / element gathers (the slot path's speed on the
    GPU is not measured yet).

    Caller contract: descriptor arrays are 128-padded, `s_lo[b]` is the
    owner row of slot b*128, and the caller has verified both static
    window-span conditions (see banded_materialize) — otherwise results
    are wrong. Returns (out_r, out_s), 0-filled outside live slots.
    """
    C = capacity
    Cb = C // _BLK
    n_s = h.shape[0]
    n_rp = r_p.shape[0]
    nb_s = n_s // _BLK
    nb_r = n_rp // _BLK

    block_starts = jnp.arange(Cb, dtype=jnp.int32) * _BLK

    # S-side windows (block gather; no masking needed except duplicate
    # clamp at the tail — duplicated rows would double-select)
    wb0 = s_lo // _BLK
    karr = jnp.arange(swb, dtype=jnp.int32)
    wblk = jnp.minimum(wb0[:, None] + karr[None, :], nb_s - 1)   # [Cb, swb]
    dup = jnp.concatenate([
        jnp.zeros((Cb, 1), bool), wblk[:, 1:] == wblk[:, :-1]], axis=1)
    h2 = h.reshape(-1, _BLK)
    fm2 = fm.reshape(-1, _BLK)
    off2 = off.reshape(-1, _BLK)
    sp2 = s_p.reshape(-1, _BLK)
    wf = wblk.reshape(-1)
    off_w = jnp.take(off2, wf, axis=0).reshape(Cb, swb * _BLK)
    h_w = jnp.take(h2, wf, axis=0).reshape(Cb, swb * _BLK)
    fm_w = jnp.take(fm2, wf, axis=0).reshape(Cb, swb * _BLK)
    sp_w = jnp.take(sp2, wf, axis=0).reshape(Cb, swb * _BLK)
    dupm = jnp.repeat(dup, _BLK, axis=1)
    hi_w = jnp.where(dupm, off_w, off_w + h_w)     # duplicate -> empty
    fmoff_w = fm_w - off_w
    ones_w = jnp.ones_like(off_w)

    pos = block_starts[:, None] + jnp.arange(_BLK, dtype=jnp.int32)[None, :]

    # Chunk both selects over slot-block rows via lax.map: the one-shot
    # variant's [Cb, 128, w*128] compare tensor blew up COMPILE time
    # superlinearly in capacity on the CPU backend (the reference's FOLD
    # ring is 2^24 slots). Per-chunk shapes make compile time
    # capacity-independent.
    CH = min(512, Cb)
    padc = -Cb % CH

    def chunked(f, *arrs):
        ar = [jnp.pad(a, ((0, padc), (0, 0)),
                      constant_values=(-1 if i == 0 else 0))
              for i, a in enumerate(arrs)]
        ar = [a.reshape(-1, CH, a.shape[1]) for a in ar]
        outs = jax.lax.map(lambda t: f(*t), tuple(ar))
        return [o.reshape(-1, o.shape[-1])[:Cb] for o in outs]

    sp_sel, fmoff_sel, valid = chunked(
        banded_interval_select, pos, off_w, hi_w, sp_w, fmoff_w, ones_w)

    r_pos = fmoff_sel + pos                        # garbage where invalid

    # R-side: equality-select r_p[r_pos] from the caller-provided
    # per-block anchor (per-S-block min fm over matched rows)
    rb0 = jnp.clip(rb0, 0, nb_r - 1)
    kr = jnp.arange(rwb, dtype=jnp.int32)
    rblk = jnp.minimum(rb0[:, None] + kr[None, :], nb_r - 1)
    rdup = jnp.concatenate([
        jnp.zeros((Cb, 1), bool), rblk[:, 1:] == rblk[:, :-1]], axis=1)
    rp2 = r_p.reshape(-1, _BLK)
    rf = rblk.reshape(-1)
    rp_w = jnp.take(rp2, rf, axis=0).reshape(Cb, rwb * _BLK)
    ridx_w = (rblk[:, :, None] * _BLK
              + jnp.arange(_BLK, dtype=jnp.int32)[None, None, :]
              ).reshape(Cb, rwb * _BLK)
    ridx_w = jnp.where(jnp.repeat(rdup, _BLK, axis=1), jnp.int32(-1), ridx_w)

    # equality-select of rp at r_pos: banded_compare_per_s's payload sum
    (r_sel,) = chunked(lambda *a: banded_compare_per_s(*a)[1:],
                       r_pos, ridx_w, rp_w)

    live = (valid > 0) & (pos < total)
    out_r = jnp.where(live, r_sel, 0).reshape(-1)
    out_s = jnp.where(live, sp_sel, 0).reshape(-1)
    return out_r, out_s


def banded_materialize(
    r_keys, r_pay, s_keys, s_pay, capacity: int, window_blocks: int = 1,
    wrap: bool = True, debug_force: str = None, sort_impl: str = None,
):
    """Materialize matched (Pr, Ps) pairs into `capacity`-sized buffers.
    (Python wrapper: resolves the sort impl into a jit static arg.)"""
    return _banded_materialize(
        r_keys, r_pay, s_keys, s_pay, capacity=capacity,
        window_blocks=window_blocks, wrap=wrap, debug_force=debug_force,
        sort_impl=resolve_sort_impl(sort_impl))


@functools.partial(jax.jit, static_argnames=("capacity", "window_blocks",
                                             "wrap", "debug_force",
                                             "sort_impl"))
def _banded_materialize(
    r_keys, r_pay, s_keys, s_pay, capacity: int, window_blocks: int,
    wrap: bool, debug_force: str, sort_impl: str,
):
    """Materialize matched (Pr, Ps) pairs into `capacity`-sized buffers.

    Returns (out_r, out_s, total_matches). When total <= capacity the output
    multiset equals the oracle's (order is engine-defined: S-sorted match
    order). With wrap=True (default) excess matches wrap around the output
    ring — match m lands in slot m mod capacity, later matches overwriting
    earlier, the FOLD-ring semantics of join_partitioned_results
    (src/join-primitives.cu:1371-1373; there the ring is 2^24 slots and the
    write order is nondeterministic; here it is the engine's S-sorted match
    order). wrap=False truncates instead.

    Extraction strategy: when no ring lap happened (total <= capacity, the
    common regime) and per-block owner spans fit static windows, the
    block-windowed fast path (_extract_blocked) runs — block gathers + two
    windowed selects, no element gathers. Otherwise the exact
    slot-path below takes over: slot pos's winning match is
    m = pos + capacity*floor((total-1-pos)/capacity); its owning S row
    comes from one searchsorted over the match-offset table, so cost stays
    O(capacity log n_s) regardless of total."""
    r_sv, r_p = sort_by_key(r_keys, r_pay, sort_impl)
    s_sv, s_p = sort_by_key(s_keys, s_pay, sort_impl)
    n_s_real = s_keys.shape[0]
    h, fm = banded_match_descriptors(r_sv, s_sv, window_blocks)
    # drop S sentinel-padding rows (at the end of the sorted order)
    h = h[:n_s_real]
    fm = fm[:n_s_real]
    s_p = s_p[:n_s_real]
    total = jnp.sum(h)  # int32 wraparound, like the reference's cursor
    off = jnp.cumsum(h) - h
    pos = jnp.arange(capacity, dtype=jnp.int32)

    # ---- block-windowed fast path + pre-checks -------------------------
    SWB, RWB = 4, 6
    C128 = -(-capacity // _BLK) * _BLK
    padd = -n_s_real % _BLK
    h_p = jnp.pad(h, (0, padd))
    fm_p = jnp.pad(fm, (0, padd))
    off_p = jnp.pad(off, (0, padd), constant_values=jnp.int32(0x7FFFFFFF))
    sp_p = jnp.pad(s_p, (0, padd))
    n_s_pad = n_s_real + padd
    block_starts = jnp.arange(C128 // _BLK, dtype=jnp.int32) * _BLK
    # Owner ANCHOR at S-block granularity: rank block starts among the
    # 128-coarse match-offset table (128x smaller rank sort than ranking
    # over off itself — the off-ranks sort dominated extraction prep at
    # 16M). The true owner row lies within 127 rows after the anchor; the
    # SWB window + span checks absorb the slack.
    coarse_off = (jnp.cumsum(jnp.sum(h_p.reshape(-1, _BLK), axis=1))
                  - jnp.sum(h_p.reshape(-1, _BLK), axis=1))
    s_blk = jnp.clip(
        _ranks_of_sorted_probes(coarse_off, block_starts,
                                a_first_on_ties=True) - 1,
        0, n_s_pad // _BLK - 1)
    s_lo = s_blk * _BLK
    s_nxt_blk = jnp.concatenate(
        [s_blk[1:], jnp.asarray([n_s_pad // _BLK - 1], jnp.int32)])
    # blocks at/after `total` are dead (all-zero output): exclude them from
    # the span checks — their "owners" are trailing h=0 rows with fm=MAX
    livep = block_starts < total
    # the true owner of slot-block b's last slot lies within anchor block
    # s_nxt_blk, so the S window must reach its end:
    ok_s = jnp.max(jnp.where(livep, s_nxt_blk - s_blk, 0)) < SWB - 1
    # R window bounds from per-S-block summaries over MATCHED rows only
    # (h=0 rows carry fm=MAX and would poison row-level bounds). fm+h is
    # monotone over matched rows (runs of distinct keys are disjoint
    # ascending; equal keys share (fm, h)).
    h2d = h_p.reshape(-1, _BLK)
    fm2d = fm_p.reshape(-1, _BLK)
    matched = h2d > 0
    blockmin_fm = jnp.min(jnp.where(matched, fm2d, jnp.int32(0x7FFFFFFF)),
                          axis=1)
    blockmax_fmh = jnp.max(jnp.where(matched, fm2d + h2d, 0), axis=1)
    rlo_rows = jnp.take(blockmin_fm, s_blk)          # anchor R row per block
    rb0 = jnp.clip(rlo_rows // _BLK, 0, r_p.shape[0] // _BLK - 1)
    # The R-span check must cover the WHOLE anchor range [s_blk, s_nxt_blk]:
    # blockmax_fmh is 0 for blocks with no matched rows, so indexing
    # s_nxt_blk alone is vacuous when that block is all-unmatched while
    # wide-fm matches sit inside the anchor block itself. fm+h is monotone
    # over matched rows, so cummax at s_nxt_blk == max over all blocks
    # <= s_nxt_blk, which bounds every owner row the slot block can touch.
    rmax_need = jnp.take(jax.lax.cummax(blockmax_fmh), s_nxt_blk)
    ok_r = jnp.max(jnp.where(livep, rmax_need - rb0 * _BLK, 0)) <= RWB * _BLK
    ok_fast = ok_s & ok_r & (jnp.int32(0) < total)
    if wrap:
        ok_fast = ok_fast & (total <= jnp.int32(capacity))

    def fast(_):
        out_r, out_s = _extract_blocked(
            h_p, fm_p, off_p, sp_p, r_p, C128, total, s_lo, rb0,
            swb=SWB, rwb=RWB)
        return out_r[:capacity], out_s[:capacity]

    def slow(_):
        return _materialize_slot_path(
            h, fm, off, s_p, r_p, capacity, total, pos, wrap,
            n_s_real, r_sv.shape[0])

    if debug_force == "fast":      # tests: prove the fast path alone
        out_r, out_s = fast(None)
    elif debug_force == "slow":
        out_r, out_s = slow(None)
    else:
        out_r, out_s = jax.lax.cond(ok_fast, fast, slow, None)
    return out_r, out_s, total


def _materialize_slot_path(h, fm, off, s_p, r_p, capacity, total, pos,
                           wrap, n_s_real, n_r_pad):
    if wrap:
        # last full-or-partial lap's match index for each ring slot
        laps = jnp.maximum(total - 1 - pos, 0) // jnp.int32(capacity)
        m = pos + laps * jnp.int32(capacity)
        s_row = jnp.clip(
            jnp.searchsorted(off, m, side="right").astype(jnp.int32) - 1,
            0, n_s_real - 1)
        r_pos = jnp.clip(jnp.take(fm, s_row) + m - jnp.take(off, s_row),
                         0, n_r_pad - 1)
        valid = pos < total
        out_r = jnp.where(valid, jnp.take(r_p, r_pos), 0)
        out_s = jnp.where(valid, jnp.take(s_p, s_row), 0)
        return out_r, out_s
    # truncating path: expand per-match descriptors by repetition (no
    # data-dependent shapes: total_repeat_length pads/truncates)
    fm_exp = jnp.repeat(fm, h, total_repeat_length=capacity)
    off_exp = jnp.repeat(off, h, total_repeat_length=capacity)
    sp_exp = jnp.repeat(s_p, h, total_repeat_length=capacity)
    npad_exp = jnp.repeat(jnp.ones_like(h), h, total_repeat_length=capacity)
    k = pos - off_exp
    r_pos = jnp.clip(fm_exp + k, 0, n_r_pad - 1)
    valid = (pos < total) & (npad_exp > 0)
    out_r = jnp.where(valid, jnp.take(r_p, r_pos), 0)
    out_s = jnp.where(valid, sp_exp, 0)
    return out_r, out_s


def banded_join_aggregate(
    r_keys, r_pay, s_keys, s_pay, window_blocks: int = 1,
    sort_impl: str = None,
) -> jnp.ndarray:
    """Full pipeline: sort both sides + banded probe, one jit, no host sync.

    SUM(Pr*Ps) over key matches, int32 wraparound."""
    return _banded_join_aggregate(r_keys, r_pay, s_keys, s_pay,
                                  window_blocks,
                                  resolve_sort_impl(sort_impl))


@functools.partial(jax.jit, static_argnames=("window_blocks", "sort_impl"))
def _banded_join_aggregate(r_keys, r_pay, s_keys, s_pay,
                           window_blocks: int, sort_impl: str):
    r_sv, r_p = sort_by_key(r_keys, r_pay, sort_impl)
    s_sv, s_p = sort_by_key(s_keys, s_pay, sort_impl)
    return banded_probe(r_sv, r_p, s_sv, s_p, window_blocks, "mul")


def banded_join_late_aggregate(
    r_keys, r_colsum, s_keys, s_colsum, window_blocks: int = 1,
    sort_impl: str = None,
) -> jnp.ndarray:
    """Late-materialization aggregate: SUM over matches of (Rcolsum +
    Scolsum), int32 wraparound (join_partitioned_varpayload analog,
    src/join-primitives.cu:1420-1557). Requires keys != -1 (sentinel)."""
    return _banded_join_late_aggregate(r_keys, r_colsum, s_keys, s_colsum,
                                       window_blocks,
                                       resolve_sort_impl(sort_impl))


@functools.partial(jax.jit, static_argnames=("window_blocks", "sort_impl"))
def _banded_join_late_aggregate(r_keys, r_colsum, s_keys, s_colsum,
                                window_blocks: int, sort_impl: str):
    r_sv, r_c = sort_by_key(r_keys, r_colsum, sort_impl)
    s_sv, s_c = sort_by_key(s_keys, s_colsum, sort_impl)
    return banded_probe(r_sv, r_c, s_sv, s_c, window_blocks, "add")


def banded_join_count(r_keys, s_keys, window_blocks: int = 1,
                      sort_impl: str = None) -> jnp.ndarray:
    """Match count (int32 wraparound; exact when < 2^31).

    Computed as SUM(1*1) over matches so that sentinel padding rows
    (payload 0) contribute nothing — the reference counts the same way
    (payloads initialized to 1, hj_ClusteredProbe,
    src/hash_join_clustered_probe.cu:1991-1999)."""
    return _banded_join_count(r_keys, s_keys, window_blocks,
                              resolve_sort_impl(sort_impl))


@functools.partial(jax.jit, static_argnames=("window_blocks", "sort_impl"))
def _banded_join_count(r_keys, s_keys, window_blocks: int, sort_impl: str):
    r_sv, r_p = sort_by_key(r_keys, jnp.ones_like(r_keys), sort_impl)
    s_sv, s_p = sort_by_key(s_keys, jnp.ones_like(s_keys), sort_impl)
    return banded_probe(r_sv, r_p, s_sv, s_p, window_blocks, "mul")
