"""Blocked-compare probe + work planning vs oracle, incl. skew."""

import jax.numpy as jnp
import numpy as np
import pytest

from icde2019_gpu_join.ops import probe as probe_ops
from icde2019_gpu_join.ops.partition import radix_partition
from icde2019_gpu_join.utils import oracle
from tests.conftest import make_tables


def run_probe(rk, rp, sk, sp, bits=6, tile=64):
    pr = radix_partition(jnp.asarray(rk), jnp.asarray(rp), bits, 0)
    ps = radix_partition(jnp.asarray(sk), jnp.asarray(sp), bits, 0)
    plan = probe_ops.plan_probe(
        np.asarray(pr.counts), np.asarray(pr.offsets[:-1]),
        np.asarray(ps.counts), np.asarray(ps.offsets[:-1]),
        tile_r=tile, tile_s=tile, pad_items_to=16,
    )
    return pr, ps, plan


def test_plan_covers_all_pairs(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=3000, n_s=9000, dup_build=True)
    pr, ps, plan = run_probe(rk, rp, sk, sp)
    # each partition's R/S rows fully tiled
    cr = np.asarray(pr.counts)
    cs = np.asarray(ps.counts)
    expect_items = int(np.sum(
        np.where((cr > 0) & (cs > 0), (-(-cr // 64)) * (-(-cs // 64)), 0)
    ))
    assert plan.num_items == expect_items
    live = plan.r_len > 0
    assert np.all(plan.r_len[live] <= 64)
    assert np.all(plan.s_len[live] <= 64)


@pytest.mark.parametrize("dup_build", [False, True])
def test_blocked_probe_aggregate(rng, dup_build):
    rk, rp, sk, sp = make_tables(rng, n_r=2000, n_s=6000, dup_build=dup_build)
    pr, ps, plan = run_probe(rk, rp, sk, sp)
    got = int(probe_ops.blocked_probe_aggregate(
        pr.keys, pr.payload, ps.keys, ps.payload, *plan.as_device(),
        tile_r=64, tile_s=64,
    ))
    assert got == oracle.join_aggregate(rk, rp, sk, sp)


def test_blocked_probe_count_and_skew(rng):
    # Zipf-ish heavy hitter: one key dominates S
    rk = rng.permutation(5000)[:1000].astype(np.int32)
    sk = rk[np.minimum(rng.zipf(1.3, size=8000) - 1, 999)].astype(np.int32)
    rp = np.ones(1000, np.int32)
    sp = np.ones(8000, np.int32)
    pr, ps, plan = run_probe(rk, rp, sk, sp, bits=4, tile=32)
    got = int(probe_ops.blocked_probe_count(
        pr.keys, ps.keys, *plan.as_device(), tile_r=32, tile_s=32,
    ))
    assert got == oracle.join_count(rk, sk)


def test_blocked_probe_materialize(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=500, n_s=1500, dup_build=True)
    pr, ps, plan = run_probe(rk, rp, sk, sp, bits=5, tile=32)
    dev = plan.as_device()
    item_counts = probe_ops.blocked_probe_item_counts(
        pr.keys, ps.keys, *dev, tile_r=32, tile_s=32)
    base = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(item_counts)[:-1]])
    total = int(jnp.sum(item_counts))
    cap = max(total, 1)
    out_r, out_s = probe_ops.blocked_probe_materialize(
        pr.keys, pr.payload, ps.keys, ps.payload, *dev, base, cap,
        tile_r=32, tile_s=32,
    )
    expect = oracle.join_materialize(rk, rp, sk, sp)
    assert total == expect.shape[0]
    got = np.stack([np.asarray(out_r)[:total], np.asarray(out_s)[:total]], axis=1)
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    assert np.array_equal(got, expect)


def test_blocked_probe_late_aggregate(rng):
    n_r, n_s = 400, 1200
    rk = rng.permutation(1000)[:n_r].astype(np.int32)
    sk = rk[rng.randint(0, n_r, size=n_s)].astype(np.int32)
    r_cols = rng.randint(-100, 100, size=(n_r, 3)).astype(np.int32)
    s_cols = rng.randint(-100, 100, size=(n_s, 2)).astype(np.int32)
    r_rowid = np.arange(n_r, dtype=np.int32)
    s_rowid = np.arange(n_s, dtype=np.int32)

    pr = radix_partition(jnp.asarray(rk), jnp.asarray(r_rowid), 5, 0)
    ps = radix_partition(jnp.asarray(sk), jnp.asarray(s_rowid), 5, 0)
    plan = probe_ops.plan_probe(
        np.asarray(pr.counts), np.asarray(pr.offsets[:-1]),
        np.asarray(ps.counts), np.asarray(ps.offsets[:-1]),
        tile_r=32, tile_s=32, pad_items_to=16,
    )
    r_colsum = jnp.sum(jnp.asarray(r_cols).astype(jnp.uint32), axis=1)[
        pr.payload].astype(jnp.int32)
    s_colsum = jnp.sum(jnp.asarray(s_cols).astype(jnp.uint32), axis=1)[
        ps.payload].astype(jnp.int32)
    got = int(probe_ops.blocked_probe_late_aggregate(
        pr.keys, r_colsum, ps.keys, s_colsum, *plan.as_device(),
        tile_r=32, tile_s=32,
    ))
    expect = oracle.join_late_materialize_sum(
        rk, r_rowid, sk, s_rowid, r_cols, s_cols)
    assert got == expect


def test_global_ht_baseline(rng):
    """C14 global chained-HT baseline analog vs oracle."""
    from icde2019_gpu_join.ops.perfect_hash import global_ht_join_aggregate

    rk = rng.randint(0, 1 << 20, 20_000).astype(np.int32)
    sk = rng.randint(0, 1 << 20, 30_000).astype(np.int32)
    rp = rng.randint(-50, 50, rk.size).astype(np.int32)
    sp = rng.randint(-50, 50, sk.size).astype(np.int32)
    got = int(global_ht_join_aggregate(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        log_buckets=8))
    assert got == oracle.join_aggregate(rk, rp, sk, sp)


def test_global_ht_no_overflow_and_negative_keys(rng):
    """Unique build keys at load factor <=0.5: pure gather-probe path,
    including negative int32 keys. Negative keys are OUTSIDE the engine
    key-domain contract, so they are only exact on the direct path —
    assert the build really had zero chain overflow (Fibonacci-hash
    collisions could in principle stack > chain_cap unique keys in one
    bucket, which would route negatives through the banded fallback and
    its -1 pad sentinel); if a jax/seed change ever trips this, pick a
    different seed rather than weakening the assert."""
    import math
    from icde2019_gpu_join.ops.perfect_hash import (
        global_ht_build, global_ht_join_aggregate)

    rk = (rng.permutation(1 << 15)[:10_000].astype(np.int32) - (1 << 14))
    sk = rk[rng.randint(0, rk.size, 25_000)].astype(np.int32)
    rp = rng.randint(-50, 50, rk.size).astype(np.int32)
    sp = rng.randint(-50, 50, sk.size).astype(np.int32)
    chain_cap = 8
    log_buckets = max(1, math.ceil(math.log2(2 * rk.size / chain_cap)))
    *_, n_ov = global_ht_build(jnp.asarray(rk), jnp.asarray(rp),
                               log_buckets, chain_cap)
    assert int(n_ov) == 0, "test premise broken: fallback would run"
    got = int(global_ht_join_aggregate(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp)))
    assert got == oracle.join_aggregate(rk, rp, sk, sp)


def test_global_ht_single_dominant_key(rng):
    """Adversarial: every build row shares one key -> one bucket chain of
    length n >> chain_cap; the overflow fallback must keep it bit-exact."""
    from icde2019_gpu_join.ops.perfect_hash import global_ht_join_aggregate

    rk = np.full(5_000, 42, np.int32)
    sk = np.where(rng.rand(8_000) < 0.5, 42, 7).astype(np.int32)
    rp = rng.randint(-50, 50, rk.size).astype(np.int32)
    sp = rng.randint(-50, 50, sk.size).astype(np.int32)
    got = int(global_ht_join_aggregate(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp)))
    assert got == oracle.join_aggregate(rk, rp, sk, sp)


def test_global_ht_jittable(rng):
    """The whole baseline (build + gather probe + cond fallback) is one
    jittable function."""
    import jax

    from icde2019_gpu_join.ops.perfect_hash import global_ht_join_aggregate

    rk = rng.randint(0, 1 << 12, 4_096).astype(np.int32)
    sk = rng.randint(0, 1 << 12, 8_192).astype(np.int32)
    rp = np.ones(rk.size, np.int32)
    sp = np.ones(sk.size, np.int32)
    fn = jax.jit(lambda a, b, c, d: global_ht_join_aggregate(a, b, c, d))
    got = int(fn(jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk),
                 jnp.asarray(sp)))
    assert got == oracle.join_aggregate(rk, rp, sk, sp)
