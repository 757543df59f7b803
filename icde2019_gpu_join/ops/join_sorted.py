"""Sort-merge equi-join via vectorized binary search.

A fully-XLA join used as (a) the non-partitioned baseline family analog
(the reference's perfect-hash / global-chain baselines,
src/join-primitives.cu:620-742) for general keys, and (b) a strong
correctness oracle on device, built from XLA sort + vectorized
searchsorted + gathers; binary search costs log(n) gathers per probe row.

Semantics match join_partitioned_aggregate (src/join-primitives.cu:885-1095):
SUM(Pr * Ps) over all matching pairs, int32 wraparound.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _sorted_build(r_keys: jnp.ndarray, r_pay: jnp.ndarray):
    """Sort the build side by key (uint32 order) and prefix-sum payloads."""
    ku = r_keys.astype(jnp.uint32)
    ks, ps = jax.lax.sort((ku, r_pay), num_keys=1, is_stable=True)
    # Exclusive prefix sums of payloads mod 2^32 (wraparound-safe).
    pref = jnp.concatenate(
        [jnp.zeros((1,), jnp.uint32), jnp.cumsum(ps.astype(jnp.uint32))]
    )
    return ks, pref


# The monolithic searchsorted+gather program crashed an earlier
# accelerator's runtime at 128M x 128M (components passed individually).
# This is an oracle, not a perf path: probe in bounded chunks as
# SEPARATE dispatches — wraparound sums are associative, so chunking never
# changes the result.
_PROBE_CHUNK = 1 << 24


@jax.jit
def _probe_chunk_sum(ks, pref, cu, cp):
    lo = jnp.searchsorted(ks, cu, side="left")
    hi = jnp.searchsorted(ks, cu, side="right")
    sub = pref[hi] - pref[lo]  # sum of matching Pr per s row, mod 2^32
    return jnp.sum(sub * cp, dtype=jnp.uint32)


def sort_merge_aggregate(
    r_keys: jnp.ndarray, r_pay: jnp.ndarray, s_keys: jnp.ndarray, s_pay: jnp.ndarray
) -> jnp.ndarray:
    """SUM(Pr*Ps) over matches, int32 wraparound. Returns scalar int32."""
    ks, pref = jax.jit(_sorted_build)(r_keys, r_pay)
    su = s_keys.astype(jnp.uint32)
    spu = s_pay.astype(jnp.uint32)
    n = su.shape[0]
    if n <= _PROBE_CHUNK:
        return _probe_chunk_sum(ks, pref, su, spu).astype(jnp.int32)
    total = jnp.uint32(0)
    for lo_i in range(0, n - n % _PROBE_CHUNK, _PROBE_CHUNK):
        total = total + _probe_chunk_sum(
            ks, pref, jax.lax.dynamic_slice(su, (lo_i,), (_PROBE_CHUNK,)),
            jax.lax.dynamic_slice(spu, (lo_i,), (_PROBE_CHUNK,)))
    tail = n % _PROBE_CHUNK
    if tail:
        total = total + _probe_chunk_sum(
            ks, pref, su[n - tail:], spu[n - tail:])
    return total.astype(jnp.int32)


def sort_merge_count(r_keys: jnp.ndarray, s_keys: jnp.ndarray) -> jnp.ndarray:
    """Number of matching pairs (int64)."""
    ku = r_keys.astype(jnp.uint32)
    ks = jax.lax.sort(ku)
    su = s_keys.astype(jnp.uint32)
    lo = jnp.searchsorted(ks, su, side="left")
    hi = jnp.searchsorted(ks, su, side="right")
    return jnp.sum((hi - lo).astype(jnp.int64))


def sort_merge_lookup(
    r_keys: jnp.ndarray, s_keys: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """For unique-key build sides: index into R of each S row's match
    (undefined where absent) and a match mask. Used by materialization of
    PK-FK joins and late materialization."""
    ku = r_keys.astype(jnp.uint32)
    order = jnp.argsort(ku)  # stable
    ks = ku[order]
    su = s_keys.astype(jnp.uint32)
    pos = jnp.searchsorted(ks, su, side="left")
    pos_c = jnp.minimum(pos, ks.shape[0] - 1)
    matched = ks[pos_c] == su
    return order[pos_c], matched
