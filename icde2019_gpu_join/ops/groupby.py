"""Hash aggregate (group-by COUNT / SUM).

The reference's aggregate story is the fused SUM(Pr*Ps) inside the probe
(join_partitioned_aggregate) plus generic min/max/sum reductions
(src/common.cu:509-778). This op generalizes it to group-by over an integer
group-id domain: sort-based segmenting (the same deterministic
permutation engine as partitioning) + wraparound-safe prefix sums — no
scatter-adds, no atomics.

For small group domains there is also a one-hot matmul path: counts/sums as
a [n, G] one-hot contraction, which XLA maps onto the MXU.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def groupby_count_sum(
    gids: jnp.ndarray, vals: jnp.ndarray, num_groups: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-group COUNT (int32) and SUM(vals) (int32, wraparound).

    gids must lie in [0, num_groups).
    """
    g_sorted, v_sorted = jax.lax.sort((gids, vals), num_keys=1, is_stable=True)
    probes = jnp.arange(num_groups + 1, dtype=g_sorted.dtype)
    offsets = jnp.searchsorted(g_sorted, probes, side="left")
    counts = jnp.diff(offsets).astype(jnp.int32)
    pref = jnp.concatenate(
        [jnp.zeros((1,), jnp.uint32), jnp.cumsum(v_sorted.astype(jnp.uint32))]
    )
    sums = (pref[offsets[1:]] - pref[offsets[:-1]]).astype(jnp.int32)
    return counts, sums


def groupby_count_sum_onehot(
    gids: jnp.ndarray, vals: jnp.ndarray, num_groups: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """MXU path for small num_groups: one-hot contraction.

    Exact for counts and for sums whose exact (unwrapped) per-group value
    fits float32's 2^24 integer window per block; blocks of 2^11 rows with
    int32 accumulation across blocks keep it exact for |vals| < 2^13. For
    general int32 vals use groupby_count_sum. Provided as the MXU-friendly
    fast path for COUNT-style aggregates.
    """
    n = gids.shape[0]
    block = 2048
    pad = (-n) % block
    g = jnp.pad(gids, (0, pad), constant_values=num_groups)
    v = jnp.pad(vals, (0, pad))
    g = g.reshape(-1, block)
    v = v.reshape(-1, block).astype(jnp.float32)

    iota = jnp.arange(num_groups, dtype=gids.dtype)

    def body(carry, gv):
        counts, sums = carry
        gb, vb = gv
        onehot = (gb[:, None] == iota[None, :]).astype(jnp.float32)
        c = jnp.sum(onehot, axis=0)
        s = jnp.dot(vb, onehot, preferred_element_type=jnp.float32)
        return (counts + c.astype(jnp.int32), sums + s.astype(jnp.int32)), None

    init = (jnp.zeros(num_groups, jnp.int32), jnp.zeros(num_groups, jnp.int32))
    (counts, sums), _ = jax.lax.scan(body, init, (g, v))
    return counts, sums
