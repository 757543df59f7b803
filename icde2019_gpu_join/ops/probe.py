"""Clustered probe: blocked-compare join over radix partitions.

An alternative to the reference's shared-memory hash-table probe
(join_partitioned_aggregate / join_partitioned_results,
src/join-primitives.cu:885-1416) and its skew decomposition
(decompose_chains, :843-874). CUDA builds a per-partition hash table in
shared memory and walks bucket chains per probe key; here we partition
*deeper* (partitions sized to ~one tile) and join each partition with a
dense masked equality block:

    eq[i, j] = (Rk[i] == Sk[j]) & valid_r[i] & valid_s[j]
    agg     += sum(eq * Pr[i] * Ps[j])        (int32 wraparound)

Work decomposition (the skew device): each partition contributes
ceil(|R_p|/TR) * ceil(|S_p|/TS) work items — the cross product of R and S
tiles. Heavy hitters automatically become many items; cost is proportional
to the true quadratic blow-up and load-balances across the grid, exactly the
role decompose_chains' <=8192-row sub-chains play in the reference. The item
table is planned on host from the (tiny) histogram — the analog of the
reference's device-side decompose_chains + kernel relaunch.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class ProbePlan:
    """Static work-item table (host-resident numpy, device-transferred once).

    Item w joins R rows [r_start[w], r_start[w]+r_len[w]) against S rows
    [s_start[w], s_start[w]+s_len[w]); zero-length items are padding.
    """

    r_start: np.ndarray
    r_len: np.ndarray
    s_start: np.ndarray
    s_len: np.ndarray
    num_items: int
    tile_r: int
    tile_s: int

    @property
    def padded_items(self) -> int:
        return self.r_start.shape[0]

    def as_device(self):
        return tuple(
            jnp.asarray(a, dtype=jnp.int32)
            for a in (self.r_start, self.r_len, self.s_start, self.s_len)
        )


def _ceil_div(a, b):
    return -(-a // b)


def plan_probe(
    counts_r: np.ndarray,
    offsets_r: np.ndarray,
    counts_s: np.ndarray,
    offsets_s: np.ndarray,
    tile_r: int = 256,
    tile_s: int = 256,
    pad_items_to: int = 1024,
) -> ProbePlan:
    """Build the work-item table from per-partition histograms (numpy).

    Item count is padded to a multiple of pad_items_to so jit caches stay
    warm across slightly different data distributions.
    """
    counts_r = np.asarray(counts_r, dtype=np.int64)
    counts_s = np.asarray(counts_s, dtype=np.int64)
    offsets_r = np.asarray(offsets_r, dtype=np.int64)
    offsets_s = np.asarray(offsets_s, dtype=np.int64)

    nbr = _ceil_div(counts_r, tile_r)
    nbs = _ceil_div(counts_s, tile_s)
    m = np.where((counts_r > 0) & (counts_s > 0), nbr * nbs, 0)
    total = int(m.sum())

    part_of_item = np.repeat(np.arange(m.shape[0]), m)
    base = np.concatenate([[0], np.cumsum(m)])[:-1]
    within = np.arange(total) - np.repeat(base, m)
    nbs_i = nbs[part_of_item]
    ir = within // np.maximum(nbs_i, 1)
    is_ = within % np.maximum(nbs_i, 1)

    r_start = offsets_r[part_of_item] + ir * tile_r
    s_start = offsets_s[part_of_item] + is_ * tile_s
    r_len = np.minimum(tile_r, counts_r[part_of_item] - ir * tile_r)
    s_len = np.minimum(tile_s, counts_s[part_of_item] - is_ * tile_s)

    padded = max(pad_items_to, _ceil_div(total, pad_items_to) * pad_items_to)

    def pad(a):
        out = np.zeros(padded, dtype=np.int32)
        out[:total] = a
        return out

    return ProbePlan(
        pad(r_start), pad(r_len), pad(s_start), pad(s_len), total, tile_r, tile_s
    )


def _gather_tile(keys, pays, start, length, tile):
    """Load a [tile] block at dynamic offset with validity mask."""
    iota = jnp.arange(tile, dtype=jnp.int32)
    idx = jnp.clip(start + iota, 0, keys.shape[0] - 1)
    valid = iota < length
    return keys[idx], pays[idx], valid


def _eq_block(rk, rv, sk, sv):
    return (rk[:, None] == sk[None, :]) & rv[:, None] & sv[None, :]


# Number of work items processed per scan step (bounds peak memory:
# chunk * TR * TS * 4B intermediates).
_CHUNK = 64


def _scan_items(item_fn, accum_init, plan_dev, chunk=_CHUNK):
    """scan over item chunks, vmapping item_fn within each chunk."""
    rs, rl, ss, sl = plan_dev
    w = rs.shape[0]
    pad = (-w) % chunk
    if pad:
        z = jnp.zeros((pad,), jnp.int32)
        rs, rl, ss, sl = (
            jnp.concatenate([a, z]) for a in (rs, rl, ss, sl)
        )
    shape = (-1, chunk)
    stacked = tuple(a.reshape(shape) for a in (rs, rl, ss, sl))

    def step(acc, args):
        out = jax.vmap(item_fn)(*args)
        return jax.tree_util.tree_map(
            lambda a, o: a + jnp.sum(o, axis=0), acc, out
        ), None

    acc, _ = jax.lax.scan(step, accum_init, stacked)
    return acc


@partial(jax.jit, static_argnames=("tile_r", "tile_s"))
def blocked_probe_aggregate(
    r_keys, r_pay, s_keys, s_pay, r_start, r_len, s_start, s_len,
    tile_r: int = 256, tile_s: int = 256,
) -> jnp.ndarray:
    """SUM(Pr*Ps) over matches (int32 wraparound), scalar int32."""

    def item(rs, rl, ss, sl):
        rk, rp, rv = _gather_tile(r_keys, r_pay, rs, rl, tile_r)
        sk, sp, sv = _gather_tile(s_keys, s_pay, ss, sl, tile_s)
        eq = _eq_block(rk, rv, sk, sv)
        prod = rp.astype(jnp.uint32)[:, None] * sp.astype(jnp.uint32)[None, :]
        return jnp.sum(jnp.where(eq, prod, jnp.uint32(0)), dtype=jnp.uint32)

    total = _scan_items(item, jnp.uint32(0), (r_start, r_len, s_start, s_len))
    return total.astype(jnp.int32)


@partial(jax.jit, static_argnames=("tile_r", "tile_s"))
def blocked_probe_count(
    r_keys, s_keys, r_start, r_len, s_start, s_len,
    tile_r: int = 256, tile_s: int = 256,
) -> jnp.ndarray:
    """Number of matching pairs (int64)."""
    one = jnp.zeros((), jnp.int32)

    def item(rs, rl, ss, sl):
        rk, _, rv = _gather_tile(r_keys, r_keys, rs, rl, tile_r)
        sk, _, sv = _gather_tile(s_keys, s_keys, ss, sl, tile_s)
        eq = _eq_block(rk, rv, sk, sv)
        return jnp.sum(eq, dtype=jnp.int64)

    del one
    total = _scan_items(item, jnp.int64(0), (r_start, r_len, s_start, s_len))
    return total


@partial(jax.jit, static_argnames=("tile_r", "tile_s"))
def blocked_probe_item_counts(
    r_keys, s_keys, r_start, r_len, s_start, s_len,
    tile_r: int = 256, tile_s: int = 256,
) -> jnp.ndarray:
    """Match count per work item [W] (phase 1 of materialization)."""

    def item(rs, rl, ss, sl):
        rk, _, rv = _gather_tile(r_keys, r_keys, rs, rl, tile_r)
        sk, _, sv = _gather_tile(s_keys, s_keys, ss, sl, tile_s)
        return jnp.sum(_eq_block(rk, rv, sk, sv), dtype=jnp.int32)

    rs, rl, ss, sl = r_start, r_len, s_start, s_len
    w = rs.shape[0]
    pad = (-w) % _CHUNK
    if pad:
        z = jnp.zeros((pad,), jnp.int32)
        rs, rl, ss, sl = (jnp.concatenate([a, z]) for a in (rs, rl, ss, sl))
    stacked = tuple(a.reshape(-1, _CHUNK) for a in (rs, rl, ss, sl))

    def step(_, args):
        return None, jax.vmap(item)(*args)

    _, counts = jax.lax.scan(step, None, stacked)
    return counts.reshape(-1)[:w]


@partial(jax.jit, static_argnames=("tile_r", "tile_s", "capacity"))
def blocked_probe_materialize(
    r_keys, r_pay, s_keys, s_pay, r_start, r_len, s_start, s_len,
    item_base,  # exclusive prefix of per-item match counts, int32
    capacity: int,
    tile_r: int = 256, tile_s: int = 256,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Write matched (Pr, Ps) pairs into ring buffers of `capacity` pairs.

    Mirrors the reference's materialization contract: a bounded output ring
    written modulo capacity (FOLD ring, src/join-primitives.cu:1099-1373) —
    deliberately wrapping when output exceeds capacity. Output order is an
    implementation detail there (atomic cursor) and here (item order), so
    parity is multiset equality when capacity >= total matches.
    """
    out_r = jnp.zeros((capacity,), jnp.int32)
    out_s = jnp.zeros((capacity,), jnp.int32)

    rs_, rl_, ss_, sl_, ib_ = r_start, r_len, s_start, s_len, item_base
    w = rs_.shape[0]
    pad = (-w) % _CHUNK
    if pad:
        z = jnp.zeros((pad,), jnp.int32)
        rs_, rl_, ss_, sl_, ib_ = (
            jnp.concatenate([a, z]) for a in (rs_, rl_, ss_, sl_, ib_)
        )
    stacked = tuple(a.reshape(-1, _CHUNK) for a in (rs_, rl_, ss_, sl_, ib_))

    def item_positions(rs, rl, ss, sl, base):
        rk, rp, rv = _gather_tile(r_keys, r_pay, rs, rl, tile_r)
        sk, sp, sv = _gather_tile(s_keys, s_pay, ss, sl, tile_s)
        eq = _eq_block(rk, rv, sk, sv).reshape(-1)
        local = jnp.cumsum(eq.astype(jnp.int32)) - 1
        pos = (base + local) % capacity
        pos = jnp.where(eq, pos, capacity)  # dropped by mode="drop"
        pr = jnp.broadcast_to(rp[:, None], (tile_r, tile_s)).reshape(-1)
        ps = jnp.broadcast_to(sp[None, :], (tile_r, tile_s)).reshape(-1)
        return pos, pr, ps

    def step(carry, args):
        o_r, o_s = carry
        pos, pr, ps = jax.vmap(item_positions)(*args)
        pos, pr, ps = pos.reshape(-1), pr.reshape(-1), ps.reshape(-1)
        o_r = o_r.at[pos].set(pr, mode="drop")
        o_s = o_s.at[pos].set(ps, mode="drop")
        return (o_r, o_s), None

    (out_r, out_s), _ = jax.lax.scan(step, (out_r, out_s), stacked)
    return out_r, out_s


@partial(jax.jit, static_argnames=("tile_r", "tile_s"))
def blocked_probe_late_aggregate(
    r_keys, r_colsum, s_keys, s_colsum, r_start, r_len, s_start, s_len,
    tile_r: int = 256, tile_s: int = 256,
) -> jnp.ndarray:
    """Late materialization aggregate (join_partitioned_varpayload analog,
    src/join-primitives.cu:1420-1557): payload columns live in separate wide
    arrays; after a match, gather + sum the extra columns. Callers pass
    per-row precomputed column sums aligned with the *partitioned* row order
    (r_colsum[i] = sum of R's extra columns for partitioned row i, uint32
    semantics), and this returns SUM over matches of (r_colsum + s_colsum)
    as wraparound int32."""

    def item(rs, rl, ss, sl):
        rk, rc, rv = _gather_tile(r_keys, r_colsum, rs, rl, tile_r)
        sk, sc, sv = _gather_tile(s_keys, s_colsum, ss, sl, tile_s)
        eq = _eq_block(rk, rv, sk, sv)
        both = rc.astype(jnp.uint32)[:, None] + sc.astype(jnp.uint32)[None, :]
        return jnp.sum(jnp.where(eq, both, jnp.uint32(0)), dtype=jnp.uint32)

    total = _scan_items(item, jnp.uint32(0), (r_start, r_len, s_start, s_len))
    return total.astype(jnp.int32)
