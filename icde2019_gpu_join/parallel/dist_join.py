"""Multi-device distributed join via shard_map.

The scaling design mandated by BASELINE.json's north star (the reference is
single-GPU; its co-processing pipeline outOfGPU_Join2 is the structural
template — host partitions <-> device shards, PCIe streams <-> collectives):

  1. each chip holds a shard of R and S (data-parallel, PartitionSpec("x"));
  2. local partition by destination chip = low log2(n) bits of the radix
     field (the global level of a two-level radix scheme) — grouped
     (radix_group, no within-bucket order) or sort-based;
  3. the all-to-all delivers (key, payload) bucket frames — the distributed
     radix shuffle;
  4. each chip joins its received sub-relations locally (remaining radix
     bits); payload-0 padding rows contribute nothing;
  5. psum produces the global aggregate (int32 wraparound is associative &
     commutative, so sharding does not change the result).

Caps: by default (`slack=None`) bucket caps come from an EXACT histogram
pre-pass (parallel/plan.py) — overflow is impossible by construction and
all_to_all volume tracks the true max bucket fill instead of a guessed
multiple. An explicit `slack` float skips the pre-pass (one less device
round-trip) and relies on AUTO-REPLAN: if the padded exchange overflows,
the wrapper recomputes exact caps and reruns — overflow is never silently
dropped and never needs a caller-side assert.

The local join inside shard_map is the banded sort-merge engine
(ops/band_join.py) — fully jittable, skew-robust, no host planning.
"""

from __future__ import annotations

import functools
import warnings
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from icde2019_gpu_join.ops.band_join import (banded_join_aggregate,
                                             banded_materialize,
                                             resolve_sort_impl)
from icde2019_gpu_join.parallel import plan as xplan
from icde2019_gpu_join.parallel.exchange import (
    all_to_all_exchange,
    all_to_all_meta,
    frame_rows,
    frames_valid_mask,
    partition_to_buckets,
    partition_to_buckets_grouped,
)

_BLK = 128


def _round128(x: int) -> int:
    return max(_BLK, -(-int(x) // _BLK) * _BLK)


def _bucketize(method: str, chunk: int):
    if method == "group":
        return partial(partition_to_buckets_grouped, chunk=chunk)
    return partition_to_buckets


def _local_join_after_exchange(rk, rp, sk, sp, axis: str, first_bit: int,
                               cap_r: int, cap_s: int, method: str,
                               chunk: int, sort_impl: str):
    nd = jax.lax.axis_size(axis)
    part = _bucketize(method, chunk)
    fr = part(rk, rp, nd, cap_r, first_bit)
    fs = part(sk, sp, nd, cap_s, first_bit)
    gk_r, gp_r = all_to_all_exchange(fr.keys, fr.pays, axis)
    gk_s, gp_s = all_to_all_exchange(fs.keys, fs.pays, axis)
    agg = banded_join_aggregate(
        gk_r.reshape(-1), gp_r.reshape(-1), gk_s.reshape(-1),
        gp_s.reshape(-1), sort_impl=sort_impl,
    )
    agg = jax.lax.psum(agg.astype(jnp.uint32), axis).astype(jnp.int32)
    overflow = jax.lax.psum(fr.overflow + fs.overflow, axis)
    return agg, overflow


def _slack_caps(slack: float, n_r: int, n_s: int, nd: int,
                segments: int = 1) -> Tuple[int, int]:
    cap_r = _round128(int(slack * (n_r // nd) / nd) + 1)
    cap_s = _round128(int(slack * (n_s // nd) / (nd * segments)) + 1)
    return cap_r, cap_s


def _exact_caps(r_keys, s_keys, mesh, axis, nd, first_bit, method, chunk,
                segments: int = 1) -> Tuple[int, int]:
    if method == "group":
        cap_r = xplan.plan_cap_grouped(r_keys, mesh, axis, nd, first_bit,
                                       chunk)
    else:
        cap_r = xplan.plan_cap(r_keys, mesh, axis, nd, first_bit)
    if segments > 1:
        cap_s = xplan.plan_cap_segmented(s_keys, mesh, axis, nd, first_bit,
                                         segments, method, chunk)
    elif method == "group":
        cap_s = xplan.plan_cap_grouped(s_keys, mesh, axis, nd, first_bit,
                                       chunk)
    else:
        cap_s = xplan.plan_cap(s_keys, mesh, axis, nd, first_bit)
    return cap_r, cap_s


def distributed_join_aggregate(
    r_keys: jnp.ndarray,
    r_pay: jnp.ndarray,
    s_keys: jnp.ndarray,
    s_pay: jnp.ndarray,
    mesh: Mesh,
    axis: str = "x",
    first_bit: int = 0,
    slack: Optional[float] = None,
    method: str = "group",
    chunk: int = 4096,
    sort_impl: Optional[str] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Global SUM(Pr*Ps) over a 1D mesh. Inputs are global arrays (sharded
    or shardable over `axis`; lengths must divide the mesh size). Returns
    (aggregate int32, overflow row count — 0 for an exact result; exact by
    construction when slack is None, auto-replanned otherwise)."""
    nd = mesh.shape[axis]
    n_r, n_s = r_keys.shape[0], s_keys.shape[0]

    impl = resolve_sort_impl(sort_impl)

    def run(cap_r, cap_s):
        fn = _aggregate_fn(mesh, axis, first_bit, cap_r, cap_s, method,
                           chunk, impl)
        return fn(r_keys, r_pay, s_keys, s_pay)

    if slack is None:
        caps = _exact_caps(r_keys, s_keys, mesh, axis, nd, first_bit,
                           method, chunk)
        return run(*caps)
    agg, ov = run(*_slack_caps(slack, n_r, n_s, nd))
    if int(ov) > 0:
        warnings.warn(
            f"exchange overflow ({int(ov)} rows) with slack={slack}; "
            "replanning with exact histogram caps and rerunning")
        caps = _exact_caps(r_keys, s_keys, mesh, axis, nd, first_bit,
                           method, chunk)
        agg, ov = run(*caps)
    return agg, ov


@functools.lru_cache(maxsize=64)
def _aggregate_fn(mesh: Mesh, axis: str, first_bit: int, cap_r: int,
                  cap_s: int, method: str, chunk: int, sort_impl: str):
    """Cached jitted shard_map — building jit(shard_map(partial(...)))
    per call defeats jax's jit cache (fresh callable identity every time)
    and re-traces/recompiles on every invocation."""
    return jax.jit(
        jax.shard_map(
            partial(
                _local_join_after_exchange,
                axis=axis, first_bit=first_bit, cap_r=cap_r, cap_s=cap_s,
                method=method, chunk=chunk, sort_impl=sort_impl,
            ),
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(), P()),
        )
    )


def _local_segmented(rk, rp, sk, sp, axis, first_bit, cap_r, cap_s,
                     num_segments, method, chunk, sort_impl):
    """Build side exchanged + sorted once (resident); probe side flows in
    segments through bucket -> all_to_all -> sort -> banded probe. The
    per-segment structure is what lets the runtime overlap segment k+1's
    exchange with segment k's probe compute (the analog of the
    reference's 3-stream double-buffered pipeline,
    src/hash_join_clustered_probe.cu:1400-1622)."""
    from icde2019_gpu_join.ops.band_join import banded_probe, sort_by_key

    nd = jax.lax.axis_size(axis)
    part = _bucketize(method, chunk)
    fr = part(rk, rp, nd, cap_r, first_bit)
    gk_r, gp_r = all_to_all_exchange(fr.keys, fr.pays, axis)
    r_sv, r_p = sort_by_key(gk_r.reshape(-1), gp_r.reshape(-1), sort_impl)

    sk_seg = sk.reshape(num_segments, -1)
    sp_seg = sp.reshape(num_segments, -1)

    def seg_step(carry, seg):
        acc, ov, recv = carry
        k, p = seg
        fs = part(k, p, nd, cap_s, first_bit)
        gk, gp = all_to_all_exchange(fs.keys, fs.pays, axis)
        # executed-balance metadata: real probe rows THIS chip received
        # this segment (round-4 verdict item 6 — measure, don't project)
        _, ct = all_to_all_meta(fs.start, fs.count, axis)
        s_sv, s_p = sort_by_key(gk.reshape(-1), gp.reshape(-1), sort_impl)
        agg = banded_probe(r_sv, r_p, s_sv, s_p, 2, "mul")
        return (acc + agg.astype(jnp.uint32), ov + fs.overflow,
                recv + jnp.sum(ct)), None

    (acc, ov_s, recv_s), _ = jax.lax.scan(
        seg_step,
        (jnp.uint32(0) + (rk[0] * 0).astype(jnp.uint32), fr.overflow * 0,
         rk[0] * 0),
        (sk_seg, sp_seg),
    )
    agg = jax.lax.psum(acc, axis).astype(jnp.int32)
    overflow = jax.lax.psum(fr.overflow + ov_s, axis)
    return agg, overflow, recv_s.reshape(1)


def distributed_join_segmented(
    r_keys, r_pay, s_keys, s_pay,
    mesh: Mesh,
    axis: str = "x",
    num_segments: int = 4,
    first_bit: int = 0,
    slack: Optional[float] = None,
    method: str = "group",
    chunk: int = 4096,
    split_heavy: Optional[bool] = None,
    sort_impl: Optional[str] = None,
    return_loads: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Distributed join with the probe side streamed in segments so the
    all-to-all of segment k+1 can overlap the banded probe of segment k
    (S_segment_size analog: min(CHUNK_SIZE, n/4),
    src/hash_join_clustered_probe.cu:1017). Returns (aggregate, overflow).
    This is the DEFAULT distributed pipeline (config 5 / dryrun).

    split_heavy: None (auto, default) runs a cheap coarse destination
    histogram; when some destination would receive >2x its fair share, the
    fine-grained PRPD heavy-split plan kicks in (heavy R broadcast + local
    heavy S, _local_heavy_segmented). True forces the fine plan; False
    disables splitting entirely.

    return_loads=True appends the EXECUTED per-chip probe load (real S
    rows each chip received through the exchange + heavy rows it kept
    local — measured from the exchanged frame metadata, not projected) as
    a host numpy [ndev] array: (agg, overflow, loads)."""
    nd = mesh.shape[axis]
    n_r, n_s = r_keys.shape[0], s_keys.shape[0]

    impl = resolve_sort_impl(sort_impl)

    def _ret(out):
        agg, ov, loads = out
        if return_loads:
            import numpy as _np
            return agg, ov, _np.asarray(loads)
        return agg, ov

    def run(cap_r, cap_s):
        fn = _segmented_fn(mesh, axis, first_bit, cap_r, cap_s,
                           num_segments, method, chunk, impl)
        return fn(r_keys, r_pay, s_keys, s_pay)

    if split_heavy is not False and slack is None and nd > 1:
        probe_fine = split_heavy is True
        if not probe_fine:
            # One extra [nd, nd] histogram stream over S per call. It can't
            # be folded into the exact-caps pre-pass for the default
            # grouped method: plan_cap_grouped counts laid-out BLOCKS (its
            # overflow unit), not per-destination rows, so it cannot answer
            # the >2x-fair-share question. One planning stream out of ~3,
            # against a join that streams the data ~10x — accepted cost.
            coarse = xplan.destination_histograms(s_keys, mesh, axis, nd,
                                                  first_bit)
            probe_fine = coarse.sum(axis=0).max() > 2.0 * (n_s / nd)
        if probe_fine:
            hplan = xplan.plan_heavy_split(r_keys, s_keys, mesh, axis, nd,
                                           first_bit,
                                           segments=num_segments)
            if hplan.split:
                fn = _heavy_segmented_fn(
                    mesh, axis, first_bit, hplan.fbits, hplan.heavy_ids,
                    hplan.cap_r, hplan.cap_s, hplan.cap_rh, num_segments,
                    impl)
                return _ret(fn(r_keys, r_pay, s_keys, s_pay))

    if slack is None:
        caps = _exact_caps(r_keys, s_keys, mesh, axis, nd, first_bit,
                           method, chunk, segments=num_segments)
        out = run(*caps)
        if int(out[1]) > 0:  # per-segment cap underestimate (skewed segs)
            caps = (caps[0], _round128(caps[1] * num_segments))
            out = run(*caps)
        return _ret(out)
    out = run(*_slack_caps(slack, n_r, n_s, nd, num_segments))
    if int(out[1]) > 0:
        warnings.warn(
            f"segmented exchange overflow ({int(out[1])} rows); replanning")
        caps = _exact_caps(r_keys, s_keys, mesh, axis, nd, first_bit,
                           method, chunk, segments=num_segments)
        out = run(*caps)
        if int(out[1]) > 0:
            caps = (caps[0], _round128(caps[1] * num_segments))
            out = run(*caps)
    return _ret(out)


@functools.lru_cache(maxsize=64)
def _segmented_fn(mesh: Mesh, axis: str, first_bit: int, cap_r: int,
                  cap_s: int, num_segments: int, method: str, chunk: int,
                  sort_impl: str):
    """Cached jitted shard_map (see _aggregate_fn)."""
    return jax.jit(
        jax.shard_map(
            partial(
                _local_segmented,
                axis=axis, first_bit=first_bit, cap_r=cap_r, cap_s=cap_s,
                num_segments=num_segments, method=method, chunk=chunk,
                sort_impl=sort_impl,
            ),
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(), P(), P(axis)),
        )
    )


def _is_heavy_mask(keys, fbits: int, first_bit: int, heavy_ids):
    """Bool mask: rows whose fine radix bucket is in the static heavy set
    (small unrolled compare chain — no gather)."""
    from icde2019_gpu_join.ops.bits import partition_ids

    fid = partition_ids(keys, fbits, first_bit)
    m = jnp.zeros(fid.shape, jnp.bool_)
    for h in heavy_ids:
        m = m | (fid == jnp.int32(h))
    return m


def _pack_heavy(keys, pays, mask, cap: int, first_bit: int,
                pad_key=None):
    """Compact the masked rows into a static [cap] frame (sort-to-front),
    pad slots payload-0 with spread keys (aggregate paths) or the constant
    `pad_key` (materialize paths, where a spread pad colliding with a real
    key would emit a phantom pair). Returns (keys, pays, overflow)."""
    from icde2019_gpu_join.ops.bits import rotate_keys, unrotate_keys
    from icde2019_gpu_join.parallel.exchange import (_SENT,
                                                     _spread_pad_keys)

    sv = jnp.where(mask, rotate_keys(keys, 0, first_bit), _SENT)
    pz = jnp.where(mask, pays, 0)
    n = sv.shape[0]
    if n < cap:
        sv = jnp.concatenate([sv, jnp.full((cap - n,), _SENT, jnp.int32)])
        pz = jnp.concatenate([pz, jnp.zeros((cap - n,), jnp.int32)])
    sv_s, p_s = jax.lax.sort((sv, pz), num_keys=1, is_stable=False)
    sv_s, p_s = sv_s[:cap], p_s[:cap]
    cnt = jnp.sum(mask.astype(jnp.int32))
    idx = jnp.arange(cap, dtype=jnp.int32)
    live = idx < cnt
    pads = (_spread_pad_keys(idx) if pad_key is None
            else jnp.full((cap,), pad_key, jnp.int32))
    out_k = jnp.where(live, unrotate_keys(sv_s, 0, first_bit), pads)
    out_p = jnp.where(live, p_s, 0)
    return out_k, out_p, jnp.maximum(cnt - cap, 0)


def _local_heavy_segmented(rk, rp, sk, sp, axis, first_bit, fbits,
                           heavy_ids, cap_r, cap_s, cap_rh, num_segments,
                           sort_impl):
    """PRPD heavy-split segmented join (north-star 'heavy-hitter skew
    detection with partition splitting'; reference analog: decompose_chains
    src/join-primitives.cu:843-874 + knapsack batching
    src/partition-primitives.cu:307-469):

      * build side: normal rows ride the usual all_to_all; rows in heavy
        fine buckets are compacted into a [cap_rh] frame and all_gather-
        REPLICATED to every chip (R's side of a hot key is small — one row
        for PK-FK — so the broadcast is cheap);
      * probe side: normal rows ride the all_to_all; heavy rows are joined
        WHERE THEY ALREADY LIVE — input placement spreads a hot key's rows
        ~uniformly over source chips, which is exactly the balance we want
        (no chip ever receives a whole hot destination).

    Exactness: heavy rows are valid-masked OUT of the normal exchange, so
    each (r, s) match pair is counted exactly once — normal x normal on the
    key's owner chip, heavy x heavy on the S row's home chip (replicated R
    makes the match local); cross terms have disjoint key sets."""
    from icde2019_gpu_join.ops.band_join import banded_probe, sort_by_key
    from icde2019_gpu_join.parallel.exchange import _spread_pad_keys

    nd = jax.lax.axis_size(axis)
    hm_r = _is_heavy_mask(rk, fbits, first_bit, heavy_ids)
    fr = partition_to_buckets(rk, rp, nd, cap_r, first_bit, valid=~hm_r)
    gk_r, gp_r = all_to_all_exchange(fr.keys, fr.pays, axis)
    hk, hp, ov_h = _pack_heavy(rk, rp, hm_r, cap_rh, first_bit)
    ghk = jax.lax.all_gather(hk, axis, tiled=True)
    ghp = jax.lax.all_gather(hp, axis, tiled=True)
    r_sv, r_p = sort_by_key(
        jnp.concatenate([gk_r.reshape(-1), ghk]),
        jnp.concatenate([gp_r.reshape(-1), ghp]), sort_impl)

    sk_seg = sk.reshape(num_segments, -1)
    sp_seg = sp.reshape(num_segments, -1)
    seg_idx = jnp.arange(sk_seg.shape[1], dtype=jnp.int32)

    def seg_step(carry, seg):
        acc, ov, recv = carry
        k, p = seg
        hm = _is_heavy_mask(k, fbits, first_bit, heavy_ids)
        fs = partition_to_buckets(k, p, nd, cap_s, first_bit, valid=~hm)
        gk, gp = all_to_all_exchange(fs.keys, fs.pays, axis)
        # executed-balance metadata: received normal rows + local heavy
        # rows = the probe rows THIS chip actually processes
        _, ct = all_to_all_meta(fs.start, fs.count, axis)
        # heavy S rows stay local; non-heavy slots become payload-0 pads
        # with spread keys (a sentinel run would blow up the band window)
        lk = jnp.where(hm, k, _spread_pad_keys(seg_idx))
        lp = jnp.where(hm, p, 0)
        s_sv, s_p = sort_by_key(
            jnp.concatenate([gk.reshape(-1), lk]),
            jnp.concatenate([gp.reshape(-1), lp]), sort_impl)
        agg = banded_probe(r_sv, r_p, s_sv, s_p, 2, "mul")
        return (acc + agg.astype(jnp.uint32), ov + fs.overflow,
                recv + jnp.sum(ct) + jnp.sum(hm.astype(jnp.int32))), None

    (acc, ov_s, recv_s), _ = jax.lax.scan(
        seg_step, (jnp.uint32(0) + (rk[0] * 0).astype(jnp.uint32),
                   fr.overflow * 0, fr.overflow * 0),
        (sk_seg, sp_seg))
    agg = jax.lax.psum(acc, axis).astype(jnp.int32)
    overflow = jax.lax.psum(fr.overflow + ov_h + ov_s, axis)
    return agg, overflow, recv_s.reshape(1)


@functools.lru_cache(maxsize=64)
def _heavy_segmented_fn(mesh: Mesh, axis: str, first_bit: int, fbits: int,
                        heavy_ids: tuple, cap_r: int, cap_s: int,
                        cap_rh: int, num_segments: int, sort_impl: str):
    """Cached jitted shard_map (see _aggregate_fn)."""
    return jax.jit(
        jax.shard_map(
            partial(
                _local_heavy_segmented,
                axis=axis, first_bit=first_bit, fbits=fbits,
                heavy_ids=heavy_ids, cap_r=cap_r, cap_s=cap_s,
                cap_rh=cap_rh, num_segments=num_segments,
                sort_impl=sort_impl,
            ),
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(), P(), P(axis)),
        )
    )


def _local_materialize(rk, rp, sk, sp, axis, first_bit, cap_r, cap_s,
                       capacity, wrap, sort_impl):
    """Exchange both sides with sort-based frames + (start,count) metadata,
    mask the received pad rows to NON-MATCHING sentinel keys, then run the
    single-chip banded materializer on the local key range.

    Pad masking is what makes materialization exact: aggregate paths only
    need pads to carry payload 0 (their spread keys may collide with real
    keys, contributing Pr*0 = 0), but a materialized (Pr, 0) row would be
    a spurious output. R pads become key -1 (sortval 0x7FFFFFFF — the
    engine's own R-side pad convention) and S pads key -2 (sortval
    0x7FFFFFFE) — both sort after every real key (>= 0 by the engine
    key-domain contract) and never equal each other. The asymmetry is
    deliberate: the banded compare kernels mask INVALID R window slots to
    _R_PAD_SV = 0x7FFFFFFF, so an S-side row carrying that same sortval
    would spuriously "match" every masked window slot (observed: 3.4M
    phantom pairs at 16K rows) — S pads must sit at 0x7FFFFFFE instead.
    Reference analog: join_partitioned_results' materializing probe
    (src/hash_join_clustered_probe.cu:1947-1961), whose atomic-cursor
    output order is nondeterministic — parity is defined on the (Pr, Ps)
    multiset."""
    nd = jax.lax.axis_size(axis)

    def xch(k, p, cap):
        f = partition_to_buckets(k, p, nd, cap, first_bit)
        gk, gp = all_to_all_exchange(f.keys, f.pays, axis)
        st, ct = all_to_all_meta(f.start, f.count, axis)
        valid = frames_valid_mask(st, ct, frame_rows(cap)).reshape(-1)
        return gk.reshape(-1), gp.reshape(-1), valid, f.overflow

    gk_r, gp_r, val_r, ov_r = xch(rk, rp, cap_r)
    gk_s, gp_s, val_s, ov_s = xch(sk, sp, cap_s)
    rk2 = jnp.where(val_r, gk_r, jnp.int32(-1))
    rp2 = jnp.where(val_r, gp_r, 0)
    sk2 = jnp.where(val_s, gk_s, jnp.int32(-2))
    sp2 = jnp.where(val_s, gp_s, 0)
    out_r, out_s, total = banded_materialize(rk2, rp2, sk2, sp2,
                                             capacity=capacity, wrap=wrap,
                                             sort_impl=sort_impl)
    overflow = jax.lax.psum(ov_r + ov_s, axis)
    return out_r, out_s, total.reshape(1), overflow


def distributed_join_materialize(
    r_keys, r_pay, s_keys, s_pay,
    mesh: Mesh,
    capacity_per_chip: int,
    axis: str = "x",
    first_bit: int = 0,
    wrap: bool = True,
    sort_impl: Optional[str] = None,
    split_heavy: Optional[bool] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Distributed materializing join over a 1D mesh: every matched
    (Pr, Ps) pair lands in the output buffer of the chip owning its key's
    radix range. Returns (out_r [nd*cap], out_s [nd*cap], totals [nd],
    overflow scalar): chip d's rows live in out_*[d*cap:(d+1)*cap], its
    true match count in totals[d] (slots >= total are zeroed; with
    wrap=True excess matches wrap the per-chip ring, the FOLD semantics of
    src/join-primitives.cu:1371-1373; wrap=False truncates). Global match
    count = totals.sum(). Caps come from the exact histogram pre-pass, so
    exchange overflow is 0 by construction.

    split_heavy (None = auto, like distributed_join_segmented): when some
    destination chip would receive >2x its fair share of S, the PRPD
    heavy split kicks in — heavy-bucket S rows materialize WHERE THEY
    LIVE against the all_gather-replicated heavy R rows, everything else
    keeps owner-chip placement. The OUTPUT MULTISET across chips is
    unchanged (tested); only the per-chip placement of heavy keys' pairs
    becomes engine-defined, which is the point: no single chip's ring
    absorbs a whole hot key (reference analog: decompose_chains applies
    to the materializing probe too, src/join-primitives.cu:843-874).

    Enforces the key-domain contract (keys >= 0) loudly: materialization
    pads received frames at keys -1/-2, so a negative REAL key would
    silently emit phantom pairs — unlike the aggregate paths, where pad
    collisions contribute payload-0 terms. One jnp.min per side, noise
    next to the exact-caps pre-pass this wrapper already runs."""
    if int(jnp.min(r_keys)) < 0 or int(jnp.min(s_keys)) < 0:
        raise ValueError(
            "distributed_join_materialize: negative keys violate the "
            "engine key-domain contract (keys >= 0; -1/-2 are reserved "
            "pad sentinels) — see PARITY.md deviations")
    nd = mesh.shape[axis]
    impl = resolve_sort_impl(sort_impl)
    if split_heavy is not False and nd > 1:
        probe_fine = split_heavy is True
        if not probe_fine:
            coarse = xplan.destination_histograms(s_keys, mesh, axis, nd,
                                                  first_bit)
            probe_fine = (coarse.sum(axis=0).max()
                          > 2.0 * (s_keys.shape[0] / nd))
        if probe_fine:
            hplan = xplan.plan_heavy_split(r_keys, s_keys, mesh, axis, nd,
                                           first_bit)
            if hplan.split:
                fn = _materialize_heavy_fn(
                    mesh, axis, first_bit, hplan.fbits, hplan.heavy_ids,
                    hplan.cap_r, hplan.cap_s, hplan.cap_rh,
                    int(capacity_per_chip), bool(wrap), impl)
                return fn(r_keys, r_pay, s_keys, s_pay)
    caps = _exact_caps(r_keys, s_keys, mesh, axis, nd, first_bit,
                       "sort", 0)
    fn = _materialize_fn(mesh, axis, first_bit, caps[0], caps[1],
                         int(capacity_per_chip), bool(wrap), impl)
    return fn(r_keys, r_pay, s_keys, s_pay)


@functools.lru_cache(maxsize=64)
def _materialize_fn(mesh: Mesh, axis: str, first_bit: int, cap_r: int,
                    cap_s: int, capacity: int, wrap: bool, sort_impl: str):
    """Cached jitted shard_map (see _aggregate_fn)."""
    return jax.jit(
        jax.shard_map(
            partial(
                _local_materialize,
                axis=axis, first_bit=first_bit, cap_r=cap_r, cap_s=cap_s,
                capacity=capacity, wrap=wrap, sort_impl=sort_impl,
            ),
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(axis), P(axis), P(axis), P()),
        )
    )


def _local_materialize_heavy(rk, rp, sk, sp, axis, first_bit, fbits,
                             heavy_ids, cap_r, cap_s, cap_rh, capacity,
                             wrap, sort_impl):
    """PRPD heavy-split materialization (see _local_heavy_segmented for
    the split argument — each match pair is produced exactly once):
    normal rows ride the valid-masked exchange with received pads masked
    to the -1/-2 sentinels (_local_materialize's convention); heavy R
    rows are packed with CONSTANT -1 pads (a spread pad could collide
    with a real S key and emit a phantom pair) and replicated; heavy S
    rows materialize on their home chip."""
    nd = jax.lax.axis_size(axis)
    hm_r = _is_heavy_mask(rk, fbits, first_bit, heavy_ids)
    hm_s = _is_heavy_mask(sk, fbits, first_bit, heavy_ids)

    def xch(k, p, cap, hm, pad):
        f = partition_to_buckets(k, p, nd, cap, first_bit, valid=~hm)
        gk, gp = all_to_all_exchange(f.keys, f.pays, axis)
        st, ct = all_to_all_meta(f.start, f.count, axis)
        valid = frames_valid_mask(st, ct, frame_rows(cap)).reshape(-1)
        return (jnp.where(valid, gk.reshape(-1), jnp.int32(pad)),
                jnp.where(valid, gp.reshape(-1), 0), f.overflow)

    rk2, rp2, ov_r = xch(rk, rp, cap_r, hm_r, -1)
    sk2, sp2, ov_s = xch(sk, sp, cap_s, hm_s, -2)
    hk, hp, ov_h = _pack_heavy(rk, rp, hm_r, cap_rh, first_bit, pad_key=-1)
    ghk = jax.lax.all_gather(hk, axis, tiled=True)
    ghp = jax.lax.all_gather(hp, axis, tiled=True)
    lk = jnp.where(hm_s, sk, jnp.int32(-2))
    lp = jnp.where(hm_s, sp, 0)
    out_r, out_s, total = banded_materialize(
        jnp.concatenate([rk2, ghk]), jnp.concatenate([rp2, ghp]),
        jnp.concatenate([sk2, lk]), jnp.concatenate([sp2, lp]),
        capacity=capacity, wrap=wrap, sort_impl=sort_impl)
    overflow = jax.lax.psum(ov_r + ov_s + ov_h, axis)
    return out_r, out_s, total.reshape(1), overflow


@functools.lru_cache(maxsize=64)
def _materialize_heavy_fn(mesh: Mesh, axis: str, first_bit: int, fbits: int,
                          heavy_ids: tuple, cap_r: int, cap_s: int,
                          cap_rh: int, capacity: int, wrap: bool,
                          sort_impl: str):
    """Cached jitted shard_map (see _aggregate_fn)."""
    return jax.jit(
        jax.shard_map(
            partial(
                _local_materialize_heavy,
                axis=axis, first_bit=first_bit, fbits=fbits,
                heavy_ids=heavy_ids, cap_r=cap_r, cap_s=cap_s,
                cap_rh=cap_rh, capacity=capacity, wrap=wrap,
                sort_impl=sort_impl,
            ),
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(axis), P(axis), P(axis), P()),
        )
    )


def _two_level_local(rk, rp, sk, sp, host_axis, chip_axis, first_bit, caps,
                     sort_impl):
    """Two-level exchange: hosts exchange over DCN first (outer radix bits),
    then chips within a host over ICI (next bits). This keeps the heavy
    all-to-all fan-in hierarchical, matching the pod's physical topology.

    Level 1 is sort-based and ships (start, count) metadata with the
    frames; level 2 masks the received pad rows out via that metadata
    before re-bucketing, so level-2 caps cover REAL rows only — no slack
    compounding (round-2's slack^2 inflation is structurally gone)."""
    (cap_r_h, cap_s_h, cap_r_c, cap_s_c) = caps
    nh = jax.lax.axis_size(host_axis)
    nc = jax.lax.axis_size(chip_axis)
    hbits = (nh - 1).bit_length()  # 0 when nh == 1 (single-bucket level)

    def two_level_side(keys, pays, cap_h, cap_c):
        # Level 1: exchange across hosts on bits [first_bit, +hbits).
        f1 = partition_to_buckets(keys, pays, nh, cap_h, first_bit)
        gk, gp = all_to_all_exchange(f1.keys, f1.pays, host_axis)
        st, ct = all_to_all_meta(f1.start, f1.count, host_axis)
        valid = frames_valid_mask(st, ct, frame_rows(cap_h)).reshape(-1)
        # Level 2: exchange across chips within the host on the next bits;
        # level-1 pad rows are masked out of every bucket.
        f2 = partition_to_buckets(gk.reshape(-1), gp.reshape(-1), nc,
                                  cap_c, first_bit + hbits, valid=valid)
        gk2, gp2 = all_to_all_exchange(f2.keys, f2.pays, chip_axis)
        # executed-balance metadata: real rows this chip received
        _, ct2 = all_to_all_meta(f2.start, f2.count, chip_axis)
        return (gk2.reshape(-1), gp2.reshape(-1),
                f1.overflow + f2.overflow, jnp.sum(ct2))

    rk2, rp2, ov_r, _ = two_level_side(rk, rp, cap_r_h, cap_r_c)
    sk2, sp2, ov_s, recv_s = two_level_side(sk, sp, cap_s_h, cap_s_c)
    agg = banded_join_aggregate(rk2, rp2, sk2, sp2, sort_impl=sort_impl)
    agg = jax.lax.psum(
        jax.lax.psum(agg.astype(jnp.uint32), chip_axis), host_axis
    ).astype(jnp.int32)
    overflow = jax.lax.psum(
        jax.lax.psum(ov_r + ov_s, chip_axis), host_axis)
    return agg, overflow, recv_s.reshape(1)


def distributed_join_aggregate_2level(
    r_keys, r_pay, s_keys, s_pay,
    mesh: Mesh,
    host_axis: str = "host",
    chip_axis: str = "chip",
    first_bit: int = 0,
    slack: Optional[float] = None,
    sort_impl: Optional[str] = None,
    split_heavy: Optional[bool] = None,
    return_loads: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two-level (DCN x ICI) distributed join over a 2D mesh. slack=None
    (default) derives exact per-level caps from one joint-histogram
    pre-pass; an explicit slack skips the pre-pass with auto-replan.

    split_heavy (None = auto): when some destination chip of the nh*nc
    mesh would receive >2x its fair share of S, the PRPD heavy split
    composes with both exchange levels (heavy R replicated mesh-wide,
    heavy S local — _two_level_heavy_local). return_loads=True appends
    the EXECUTED per-chip probe load [nh*nc] (host-major) measured from
    the exchanged frame metadata."""
    nh, nc = mesh.shape[host_axis], mesh.shape[chip_axis]
    nd = nh * nc
    n_r, n_s = r_keys.shape[0], s_keys.shape[0]

    impl = resolve_sort_impl(sort_impl)

    def _ret(out):
        agg, ov, loads = out
        if return_loads:
            import numpy as _np
            return agg, ov, _np.asarray(loads)
        return agg, ov

    def run(caps):
        fn = _two_level_fn(mesh, host_axis, chip_axis, first_bit, caps,
                           impl)
        return fn(r_keys, r_pay, s_keys, s_pay)

    def exact():
        cr_h, cr_c = xplan.plan_caps_2level(r_keys, mesh, host_axis,
                                            chip_axis, first_bit)
        cs_h, cs_c = xplan.plan_caps_2level(s_keys, mesh, host_axis,
                                            chip_axis, first_bit)
        return (cr_h, cs_h, cr_c, cs_c)

    if split_heavy is not False and slack is None and nd > 1:
        probe_fine = split_heavy is True
        if not probe_fine:
            coarse = xplan.fine_histograms_2d(
                s_keys, mesh, host_axis, chip_axis,
                (nh - 1).bit_length() + (nc - 1).bit_length(), first_bit)
            probe_fine = coarse.sum(axis=0).max() > 2.0 * (n_s / nd)
        if probe_fine:
            hplan = xplan.plan_heavy_split_2level(
                r_keys, s_keys, mesh, host_axis, chip_axis, first_bit)
            if hplan.split:
                fn = _two_level_heavy_fn(
                    mesh, host_axis, chip_axis, first_bit, hplan.fbits,
                    hplan.heavy_ids,
                    (hplan.cap_r_h, hplan.cap_s_h, hplan.cap_r_c,
                     hplan.cap_s_c), hplan.cap_rh, impl)
                return _ret(fn(r_keys, r_pay, s_keys, s_pay))

    if slack is None:
        return _ret(run(exact()))
    shard_r = n_r // (nh * nc)
    shard_s = n_s // (nh * nc)
    caps = (
        _round128(int(slack * shard_r / nh) + 1),
        _round128(int(slack * shard_s / nh) + 1),
        # level 2 sees ~shard rows per chip of REAL data (pads are masked):
        # no slack^2 compounding
        _round128(int(slack * shard_r / nc) + 1),
        _round128(int(slack * shard_s / nc) + 1),
    )
    out = run(caps)
    if int(out[1]) > 0:
        warnings.warn(
            f"2-level exchange overflow ({int(out[1])} rows); replanning")
        out = run(exact())
    return _ret(out)


@functools.lru_cache(maxsize=64)
def _two_level_fn(mesh: Mesh, host_axis: str, chip_axis: str,
                  first_bit: int, caps, sort_impl: str):
    """Cached jitted shard_map (see _aggregate_fn)."""
    return jax.jit(
        jax.shard_map(
            partial(
                _two_level_local,
                host_axis=host_axis, chip_axis=chip_axis, first_bit=first_bit,
                caps=caps, sort_impl=sort_impl,
            ),
            mesh=mesh,
            in_specs=(P((host_axis, chip_axis)),) * 4,
            out_specs=(P(), P(), P((host_axis, chip_axis))),
        )
    )


def _two_level_heavy_local(rk, rp, sk, sp, host_axis, chip_axis, first_bit,
                           fbits, heavy_ids, caps, cap_rh, sort_impl):
    """PRPD heavy split composed with the two-level exchange: heavy-bucket
    rows skip BOTH exchange levels — heavy R is replicated to every chip
    of the 2D mesh (all_gather over chip then host axis), heavy S joins
    where it lives; normal rows ride the usual valid-masked two levels.
    Same exactly-once argument as _local_heavy_segmented."""
    from icde2019_gpu_join.parallel.exchange import _spread_pad_keys

    (cap_r_h, cap_s_h, cap_r_c, cap_s_c) = caps
    nh = jax.lax.axis_size(host_axis)
    nc = jax.lax.axis_size(chip_axis)
    hbits = (nh - 1).bit_length()

    def side(keys, pays, cap_h, cap_c, hm):
        f1 = partition_to_buckets(keys, pays, nh, cap_h, first_bit,
                                  valid=~hm)
        gk, gp = all_to_all_exchange(f1.keys, f1.pays, host_axis)
        st, ct = all_to_all_meta(f1.start, f1.count, host_axis)
        valid = frames_valid_mask(st, ct, frame_rows(cap_h)).reshape(-1)
        f2 = partition_to_buckets(gk.reshape(-1), gp.reshape(-1), nc,
                                  cap_c, first_bit + hbits, valid=valid)
        gk2, gp2 = all_to_all_exchange(f2.keys, f2.pays, chip_axis)
        _, ct2 = all_to_all_meta(f2.start, f2.count, chip_axis)
        return (gk2.reshape(-1), gp2.reshape(-1),
                f1.overflow + f2.overflow, jnp.sum(ct2))

    hm_r = _is_heavy_mask(rk, fbits, first_bit, heavy_ids)
    hm_s = _is_heavy_mask(sk, fbits, first_bit, heavy_ids)
    rk2, rp2, ov_r, _ = side(rk, rp, cap_r_h, cap_r_c, hm_r)
    sk2, sp2, ov_s, recv_s = side(sk, sp, cap_s_h, cap_s_c, hm_s)
    hk, hp, ov_h = _pack_heavy(rk, rp, hm_r, cap_rh, first_bit)
    ghk = jax.lax.all_gather(
        jax.lax.all_gather(hk, chip_axis, tiled=True), host_axis, tiled=True)
    ghp = jax.lax.all_gather(
        jax.lax.all_gather(hp, chip_axis, tiled=True), host_axis, tiled=True)
    idx = jnp.arange(sk.shape[0], dtype=jnp.int32)
    lk = jnp.where(hm_s, sk, _spread_pad_keys(idx))
    lp = jnp.where(hm_s, sp, 0)
    agg = banded_join_aggregate(
        jnp.concatenate([rk2, ghk]), jnp.concatenate([rp2, ghp]),
        jnp.concatenate([sk2, lk]), jnp.concatenate([sp2, lp]),
        sort_impl=sort_impl)
    agg = jax.lax.psum(
        jax.lax.psum(agg.astype(jnp.uint32), chip_axis), host_axis
    ).astype(jnp.int32)
    overflow = jax.lax.psum(
        jax.lax.psum(ov_r + ov_s + ov_h, chip_axis), host_axis)
    loads = recv_s + jnp.sum(hm_s.astype(jnp.int32))
    return agg, overflow, loads.reshape(1)


@functools.lru_cache(maxsize=64)
def _two_level_heavy_fn(mesh: Mesh, host_axis: str, chip_axis: str,
                        first_bit: int, fbits: int, heavy_ids: tuple,
                        caps, cap_rh: int, sort_impl: str):
    """Cached jitted shard_map (see _aggregate_fn)."""
    return jax.jit(
        jax.shard_map(
            partial(
                _two_level_heavy_local,
                host_axis=host_axis, chip_axis=chip_axis,
                first_bit=first_bit, fbits=fbits, heavy_ids=heavy_ids,
                caps=caps, cap_rh=cap_rh, sort_impl=sort_impl,
            ),
            mesh=mesh,
            in_specs=(P((host_axis, chip_axis)),) * 4,
            out_specs=(P(), P(), P((host_axis, chip_axis))),
        )
    )
