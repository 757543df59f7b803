"""Radix sort over (key, payload) columns.

Part of the operator set mandated by the engine's scope (BASELINE.json north
star). Built directly on the partitioning machinery: a full-width radix
partition *is* a radix sort (uint32 key order). The multi-pass variant
composes stable LSB-first passes, exercising the same pass plan as the
Pallas partitioner.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def radix_sort(
    keys: jnp.ndarray, payload: jnp.ndarray, bits: int = 32, lsb_first_passes: int = 0
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Stable sort by the low `bits` of uint32(key); payload carried along.

    lsb_first_passes > 0 forces an explicit multi-pass radix composition
    with ceil(bits / passes) bits per pass (otherwise one fused sort).
    """
    ku = keys.astype(jnp.uint32)
    if lsb_first_passes <= 1:
        mask = jnp.uint32((1 << bits) - 1) if bits < 32 else jnp.uint32(0xFFFFFFFF)
        ks, keys_out, pay_out = jax.lax.sort(
            (ku & mask, keys, payload), num_keys=1, is_stable=True
        )
        del ks
        return keys_out, pay_out

    per = -(-bits // lsb_first_passes)
    k, v = keys, payload
    shift = 0
    while shift < bits:
        b = min(per, bits - shift)
        digit = (k.astype(jnp.uint32) >> jnp.uint32(shift)) & jnp.uint32((1 << b) - 1)
        _, k, v = jax.lax.sort((digit, k, v), num_keys=1, is_stable=True)
        shift += b
    return k, v


def packed_sort_pairs(sv: jnp.ndarray, pv: jnp.ndarray):
    """Sort (sv, pv) by signed-int32 sv ascending as ONE uint64 operand:
    (biased sv << 32 | uint32 pv), which is order-preserving, then unpack.

    The 1-operand alternative to the 2-operand `lax.sort` of
    ops.band_join.sort_pairs (sort_impl="packed"). Payloads of equal keys
    come out in ascending-uint32 order, which is within the engine's
    contract (per-key payload multiset, order unspecified)."""
    with jax.enable_x64(True):
        ku = (sv.astype(jnp.uint32) ^ jnp.uint32(0x80000000)).astype(
            jnp.uint64)
        pu = pv.astype(jnp.uint32).astype(jnp.uint64)
        w = jnp.sort((ku << jnp.uint64(32)) | pu)
        ko = ((w >> jnp.uint64(32)).astype(jnp.uint32)
              ^ jnp.uint32(0x80000000)).astype(jnp.int32)
        vo = w.astype(jnp.uint32).astype(jnp.int32)
    return ko, vo
