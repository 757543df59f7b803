"""Prefix-sum / reduction utilities (reference C6 analog).

The reference carries a hand-rolled block/grid scan + reduce library
(src/common.cu:106-880: prefixSum_before*, sum/min/max reductions,
totalPrefixSum, aggregate). In JAX these are one-liners over XLA's fused
scan/reduce machinery; they're wrapped here so the engine has a single
audited implementation of the wraparound-safe variants the join semantics
need (histogram->offsets is the core of deterministic radix partitioning).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def exclusive_scan(x: jnp.ndarray) -> jnp.ndarray:
    """Exclusive prefix sum along axis 0, same dtype."""
    return jnp.concatenate([jnp.zeros((1,), x.dtype), jnp.cumsum(x)[:-1]])


def offsets_from_counts(counts: jnp.ndarray) -> jnp.ndarray:
    """CSR offsets [parts+1] from per-partition counts."""
    return jnp.concatenate(
        [jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)]
    )


def wrap_prefix_u32(vals: jnp.ndarray) -> jnp.ndarray:
    """Inclusive prefix sums of int32 values mod 2^32 with a leading zero —
    the wraparound-safe segmented-sum building block."""
    return jnp.concatenate(
        [jnp.zeros((1,), jnp.uint32), jnp.cumsum(vals.astype(jnp.uint32))]
    )


def aggregate(x: jnp.ndarray, func_id: int) -> jnp.ndarray:
    """min/max/sum dispatch by id (reference `aggregate` kernel,
    src/common.cu:763-778: funcId 0=min, 1=max, 2=sum)."""
    if func_id == 0:
        return jnp.min(x)
    if func_id == 1:
        return jnp.max(x)
    if func_id == 2:
        return jnp.sum(x)
    raise ValueError(f"unknown funcId {func_id}")


def segmented_sum_u32(vals: jnp.ndarray, offsets: jnp.ndarray) -> jnp.ndarray:
    """Per-segment sums mod 2^32 given CSR offsets [segments+1]."""
    pref = wrap_prefix_u32(vals)
    return pref[offsets[1:]] - pref[offsets[:-1]]


def associative_scan_sum(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive scan via jax.lax.associative_scan (log-depth; the analog of
    the reference's tree-structured totalPrefixSum, src/common.cu:838-880)."""
    return jax.lax.associative_scan(jnp.add, x)
