"""Fused relational pipelines.

BASELINE.json config 3: filter -> hash join probe -> group-by aggregate
(count/sum), fused. The reference's analog capability is the
late-materialization probe summing extra columns inside the probe kernel
(join_partitioned_varpayload, src/join-primitives.cu:1420-1557).

Semantics of `filter_probe_groupby`:
    SELECT s.group_id, COUNT(*), SUM(r.payload)
    FROM S JOIN R ON S.key = R.key
    WHERE lo <= S.filter_col < hi
    GROUP BY s.group_id
with group ids in [0, num_groups). R may contain duplicate keys (COUNT and
SUM are over all matching pairs). Requires keys >= 0 (engine sentinel
contract).

Execution is fully fused on the banded engine: filtered-out S rows are
masked to a never-matching sentinel key (-2) BEFORE the sort, the group id
rides as the sort payload, the per-S-element banded probe kernel produces
(match_count h, matched-R-payload sum t), and the group-by reduces (h, t)
by group id with a sort-based segmented reduction (exact uint32 prefix
sums; see _groupby_sums2_exact for why not one-hot matmuls or scatter-add).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from icde2019_gpu_join.ops.band_join import (
    banded_probe_per_s,
    resolve_sort_impl,
    sort_by_key,
)
from icde2019_gpu_join.ops.filter import filter_by_mask


def _groupby_sums2_exact(gids, vals1, vals2, num_groups: int):
    """(SUM(vals1), SUM(vals2)) per group, int32 wraparound.

    Sort-based segmented reduction: one (gid, v1, v2) sort groups rows, a
    uint32 prefix sum + G+1 boundary probes produce exact per-group sums.
    It replaced a one-hot-matmul route (which materializes an [n, 256, G]
    operand under scan) and scatter-add (segment_sum); which form is fastest
    on the GPU is not measured yet (ROADMAP S6).
    """
    g_s, v1_s, v2_s = jax.lax.sort((gids, vals1, vals2), num_keys=1,
                                   is_stable=False)
    bounds = jnp.searchsorted(
        g_s, jnp.arange(num_groups + 1, dtype=jnp.int32), side="left"
    )

    def seg_sums(v):
        pref = jnp.concatenate([
            jnp.zeros((1,), jnp.uint32),
            jnp.cumsum(v.astype(jnp.uint32)),
        ])
        return (pref[bounds][1:] - pref[bounds][:-1]).astype(jnp.int32)

    return seg_sums(v1_s), seg_sums(v2_s)


def filter_probe_groupby(
    r_keys: jnp.ndarray,
    r_pay: jnp.ndarray,
    s_keys: jnp.ndarray,
    s_filter_col: jnp.ndarray,
    s_group_id: jnp.ndarray,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    num_groups: int,
    window_blocks: int = 1,
    sort_impl: str = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (per-group match COUNT int32, per-group SUM(r_pay) int32
    wraparound). Non-matching / filtered-out rows contribute nothing."""
    return _filter_probe_groupby(
        r_keys, r_pay, s_keys, s_filter_col, s_group_id, lo, hi,
        num_groups, window_blocks, resolve_sort_impl(sort_impl))


@partial(jax.jit, static_argnames=("num_groups", "window_blocks",
                                   "sort_impl"))
def _filter_probe_groupby(r_keys, r_pay, s_keys, s_filter_col, s_group_id,
                          lo, hi, num_groups: int, window_blocks: int,
                          sort_impl: str):
    keep = (s_filter_col >= lo) & (s_filter_col < hi)
    # Dead rows -> sentinel key -2 (sv 0x7FFFFFFE: sorts to the end, matches
    # nothing — R-side pads use -1). Group id rides as the sort payload.
    sk_masked = jnp.where(keep, s_keys, jnp.int32(-2))
    n_s = s_keys.shape[0]
    s_sv, s_gid = sort_by_key(sk_masked, s_group_id, sort_impl)
    r_sv, r_p = sort_by_key(r_keys, r_pay, sort_impl)
    h, t = banded_probe_per_s(r_sv, r_p, s_sv, window_blocks=window_blocks)
    # S sentinel padding rows sit at the very end of the sorted order and may
    # carry garbage h (pad-vs-pad key equality); drop them statically.
    h = h[:n_s]
    t = t[:n_s]
    gid = s_gid[:n_s]
    return _groupby_sums2_exact(gid, h, t, num_groups)


@partial(jax.jit, static_argnames=("sort_impl",))
def _sort_r_for_probe(r_keys, r_pay, sort_impl: str):
    return sort_by_key(r_keys, r_pay, sort_impl)


@partial(jax.jit, static_argnames=("num_groups", "window_blocks",
                                   "sort_impl"))
def _fpg_segment(r_sv, r_p, s_keys, s_filter_col, s_group_id, lo, hi,
                 num_groups: int, window_blocks: int, sort_impl: str):
    """One probe-side segment of filter->probe->group-by against
    pre-sorted R. Returns the segment's per-group (COUNT, SUM) partials."""
    keep = (s_filter_col >= lo) & (s_filter_col < hi)
    sk_masked = jnp.where(keep, s_keys, jnp.int32(-2))
    n_s = s_keys.shape[0]
    s_sv, s_gid = sort_by_key(sk_masked, s_group_id, sort_impl)
    h, t = banded_probe_per_s(r_sv, r_p, s_sv, window_blocks=window_blocks)
    return _groupby_sums2_exact(s_gid[:n_s], h[:n_s], t[:n_s], num_groups)


def filter_probe_groupby_streamed(
    r_keys, r_pay, s_keys, s_filter_col, s_group_id, lo, hi,
    num_groups: int, segments: int, window_blocks: int = 1,
    sort_impl: str = None):
    """filter_probe_groupby with the probe side processed in `segments`
    equal slices — the out-of-device-memory regime for config 3 at nominal
    scale (at 2^29 probe rows the fused pipeline's arguments plus
    temporaries are ~18 GB). Same COUNT/SUM-mod-2^32 semantics: per-group
    partials from each segment accumulate exactly in uint32.

    The reference handles this scale by streaming the probe side through
    fixed device buffers (hash_join_clustered_probe.cu, Join3); here each
    segment reruns the fused sort->banded-probe->group-by at segment
    shape, so XLA compiles ONE segment program reused for all slices.
    """
    import numpy as np

    impl = resolve_sort_impl(sort_impl)
    r_sv, r_p = _sort_r_for_probe(jnp.asarray(r_keys), jnp.asarray(r_pay),
                                  impl)
    s_keys = jnp.asarray(s_keys)
    s_filter_col = jnp.asarray(s_filter_col)
    s_group_id = jnp.asarray(s_group_id)
    n = s_keys.shape[0]
    if n % segments:
        raise ValueError(f"segments={segments} must divide n_s={n}")
    seg = n // segments
    cnt = np.zeros(num_groups, np.uint32)
    sums = np.zeros(num_groups, np.uint32)
    for i in range(segments):
        sl = slice(i * seg, (i + 1) * seg)
        h, t = _fpg_segment(
            r_sv, r_p, s_keys[sl], s_filter_col[sl], s_group_id[sl],
            jnp.int32(lo), jnp.int32(hi), num_groups, window_blocks, impl)
        cnt += np.asarray(h).view(np.uint32)
        sums += np.asarray(t).view(np.uint32)
    return cnt.view(np.int32), sums.view(np.int32)


@partial(jax.jit, static_argnames=("num_groups",))
def filter_groupby(
    keys: jnp.ndarray,
    vals: jnp.ndarray,
    group_id: jnp.ndarray,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    num_groups: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Filter on key range then group-by count/sum (no join)."""
    keep = (keys >= lo) & (keys < hi)
    gids = jnp.where(keep, group_id, num_groups)
    vals = jnp.where(keep, vals, 0)
    return _groupby_sums2_exact(gids, keep.astype(jnp.int32), vals, num_groups)


def filter_then_join_aggregate(r, s, s_filter_col, lo, hi, config=None):
    """Filter S, then full clustered-probe join aggregate — the composed
    (non-fused) strategy for comparison with the fused path."""
    from icde2019_gpu_join.models.joins import ClusteredJoin
    from icde2019_gpu_join.relation import Relation

    keep = (s_filter_col >= lo) & (s_filter_col < hi)
    keys_c, pays_c, count = filter_by_mask(s.keys, s.payload, keep)
    # static-shape: keep the padded arrays, zero payloads beyond count
    valid = jnp.arange(keys_c.shape[0]) < count
    pays_c = jnp.where(valid, pays_c, 0)
    engine = ClusteredJoin(config) if config else ClusteredJoin()
    return engine.aggregate(Relation(r.keys, r.payload), Relation(keys_c, pays_c))
