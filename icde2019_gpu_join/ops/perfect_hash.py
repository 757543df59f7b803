"""Perfect-hash (dense-key) join: the fast path when build keys are dense.

Analog of the reference's non-partitioned baseline build_perfect_array /
probe_perfect_array (src/join-primitives.cu:628-668): when build keys are
unique and bounded by a known domain size, the "hash table" is a dense
payload array indexed by key: one scatter to build, gathers to probe — the
natural fast path for the 1M⋈16M dense PK-FK benchmark config.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Domain slot for "no build row": payload 0 contributes nothing to SUM(Pr*Ps).
_EMPTY = jnp.int32(0)


def perfect_hash_build(
    r_keys: jnp.ndarray, r_pay: jnp.ndarray, domain: int
) -> jnp.ndarray:
    """Dense table t[key] = payload (keys assumed unique, in [0, domain))."""
    table = jnp.zeros((domain,), dtype=jnp.int32)
    return table.at[r_keys].set(r_pay, mode="drop")


def perfect_hash_probe_aggregate(
    table: jnp.ndarray, s_keys: jnp.ndarray, s_pay: jnp.ndarray
) -> jnp.ndarray:
    """SUM(Pr*Ps) with int32 wraparound via gather + fused multiply-reduce."""
    pr = table[jnp.clip(s_keys, 0, table.shape[0] - 1)]
    in_domain = (s_keys >= 0) & (s_keys < table.shape[0])
    pr = jnp.where(in_domain, pr, _EMPTY)
    total = jnp.sum(pr.astype(jnp.uint32) * s_pay.astype(jnp.uint32), dtype=jnp.uint32)
    return total.astype(jnp.int32)


def perfect_hash_probe_materialize(
    table_pay: jnp.ndarray,
    table_occupied: jnp.ndarray,
    s_keys: jnp.ndarray,
    s_pay: jnp.ndarray,
):
    """Per-S-row matched build payload + mask (PK build side: <=1 match)."""
    idx = jnp.clip(s_keys, 0, table_pay.shape[0] - 1)
    in_domain = (s_keys >= 0) & (s_keys < table_pay.shape[0])
    hit = in_domain & table_occupied[idx]
    return jnp.where(hit, table_pay[idx], _EMPTY), hit


def perfect_hash_build_occupancy(r_keys: jnp.ndarray, domain: int) -> jnp.ndarray:
    occ = jnp.zeros((domain,), dtype=jnp.bool_)
    return occ.at[r_keys].set(True, mode="drop")


def _fib_bucket(keys: jnp.ndarray, log_buckets: int) -> jnp.ndarray:
    """Multiplicative (Fibonacci) hash bucket of each key. The reference
    buckets on hasht(key)'s low bits (identity hash); a real hash keeps
    global-HT chains short for ANY key distribution, which matters here
    because chains are bounded (see global_ht_join_aggregate)."""
    u = keys.astype(jnp.uint32) * jnp.uint32(0x9E3779B1)
    return (u >> jnp.uint32(32 - log_buckets)).astype(jnp.int32)


def global_ht_build(r_keys, r_pay, log_buckets: int, chain_cap: int):
    """Build the global chained hash table as dense [H, C] key/payload
    planes (H = 2^log_buckets buckets, C = chain_cap slots per bucket —
    the analog of the reference's max_chain bound, src/common.h:66).

    Slot ranks come from one sort by bucket id (deterministic; replaces
    the reference's atomic head/next chaining, build_ht_chains,
    src/join-primitives.cu:681-700) and a single unique-index scatter.
    Rows whose in-bucket rank exceeds C are overflow: their payloads are
    returned zeroed in `residual_pay` alongside the original keys so the
    caller can join exactly the overflow rows through a fallback path.

    Empty slots hold payload 0, so they contribute nothing to SUM(Pr*Ps)
    and no occupancy plane is needed.
    """
    n = r_keys.shape[0]
    h = _fib_bucket(r_keys, log_buckets)
    # Sort rows by bucket; rank within bucket = position - first position
    # of that bucket (searchsorted of the sorted array into itself).
    hb, kk, pp = jax.lax.sort((h, r_keys, r_pay), num_keys=1, is_stable=False)
    first = jnp.searchsorted(hb, hb, side="left")
    rank = jnp.arange(n, dtype=jnp.int32) - first.astype(jnp.int32)
    fits = rank < chain_cap
    # overflow rows target slot C (out of bounds) so mode="drop" discards
    # them instead of clobbering the bucket's rank-0 entry
    slot = jnp.where(fits, rank, chain_cap)
    table_k = jnp.zeros((1 << log_buckets, chain_cap), jnp.int32)
    table_p = jnp.zeros((1 << log_buckets, chain_cap), jnp.int32)
    table_k = table_k.at[hb, slot].set(kk, mode="drop")
    table_p = table_p.at[hb, slot].set(pp, mode="drop")
    overflow_keys = kk
    overflow_pay = jnp.where(fits, 0, pp)
    n_overflow = jnp.sum((~fits).astype(jnp.int32))
    return table_k, table_p, overflow_keys, overflow_pay, n_overflow


def global_ht_probe_aggregate(table_k, table_p, s_keys, s_pay,
                              log_buckets: int, chunk: int = 1 << 20):
    """Probe the global table: per S row, gather its bucket's C slots and
    accumulate Pr*Ps over key matches (chains_probing analog,
    src/join-primitives.cu:703-742 — the chain walk becomes a C-wide
    vectorized compare over the gathered slots). Chunked with lax.map so
    the [chunk, C] gather intermediate stays bounded."""
    n = s_keys.shape[0]
    pad = (-n) % chunk
    if pad:
        # pad payload 0 -> contributes 0 regardless of key matches
        s_keys = jnp.concatenate([s_keys, jnp.zeros((pad,), jnp.int32)])
        s_pay = jnp.concatenate([s_pay, jnp.zeros((pad,), jnp.int32)])
    sk = s_keys.reshape(-1, chunk)
    sp = s_pay.reshape(-1, chunk)

    def one_chunk(args):
        k, p = args
        b = _fib_bucket(k, log_buckets)
        slots_k = table_k[b]                      # [chunk, C] gather
        slots_p = table_p[b]
        match = slots_k == k[:, None]
        pr = jnp.sum(
            jnp.where(match, slots_p, 0).astype(jnp.uint32), axis=1,
            dtype=jnp.uint32)
        return jnp.sum(pr * p.astype(jnp.uint32), dtype=jnp.uint32)

    partials = jax.lax.map(one_chunk, (sk, sp))
    return jnp.sum(partials, dtype=jnp.uint32).astype(jnp.int32)


def global_ht_join_aggregate(r_keys, r_pay, s_keys, s_pay,
                             log_buckets: int | None = None,
                             chain_cap: int = 8,
                             sort_impl: str | None = None):
    """Global chained-hash-table join baseline (build_ht_chains /
    chains_probing analog, src/join-primitives.cu:681-742): ONE table over
    the whole build side in device memory, probed by random access — no
    partitioning. The chain walk is a bounded [H, C] slot plane gathered
    per probe row; C is the max_chain analog.

    Build rows past a bucket's C slots (possible under heavy key
    duplication) are joined exactly through a zero-masked fallback pass
    over the sorted engine, entered only when overflow exists (lax.cond).
    Bit-exact for any input WITHIN the engine key-domain contract (keys
    >= 0, relation.py): the fallback runs the banded engine, whose -1 pad
    sentinel maps to sortval 0x7FFFFFFF — a negative real key could alias
    it. The direct (no-overflow) gather-probe path alone tolerates any
    int32 key, which the negative-key test exercises with an asserted
    zero-overflow build.

    Returns int32 SUM(Pr*Ps) with uint32 wraparound.
    """
    if log_buckets is None:
        # load factor <= 0.5: H >= 2 * n_r / C buckets
        import math
        n = max(int(r_keys.shape[0]), 1)
        log_buckets = max(1, math.ceil(math.log2(2 * n / chain_cap)))
    table_k, table_p, ov_keys, ov_pay, n_ov = global_ht_build(
        r_keys, r_pay, log_buckets, chain_cap)
    total = global_ht_probe_aggregate(
        table_k, table_p, s_keys, s_pay, log_buckets)

    def with_overflow(_):
        from icde2019_gpu_join.ops.band_join import banded_join_aggregate
        return banded_join_aggregate(ov_keys, ov_pay, s_keys, s_pay,
                                     sort_impl=sort_impl)

    residual = jax.lax.cond(
        n_ov > 0, with_overflow, lambda _: jnp.int32(0), operand=None)
    return (total.astype(jnp.uint32) + residual.astype(jnp.uint32)
            ).astype(jnp.int32)
