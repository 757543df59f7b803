"""Multi-chip distributed join on a virtual 8-device CPU mesh
(SURVEY.md §4 item 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icde2019_gpu_join.parallel import (
    distributed_join_aggregate,
    distributed_join_aggregate_2level,
    make_mesh,
)
from icde2019_gpu_join.parallel.mesh import make_mesh_2d
from icde2019_gpu_join.utils import oracle
from tests.conftest import make_tables


needs_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@needs_8
@pytest.mark.parametrize("method", ["group", "sort"])
def test_distributed_aggregate_matches_oracle(rng, method):
    rk, rp, sk, sp = make_tables(rng, n_r=4096, n_s=16384, dup_build=True)
    mesh = make_mesh(8)
    # slack=None (default): exact caps from the histogram pre-pass
    agg, overflow = distributed_join_aggregate(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh, method=method,
    )
    assert int(overflow) == 0
    assert int(agg) == oracle.join_aggregate(rk, rp, sk, sp)


@needs_8
def test_distributed_pkfk_count(rng):
    n_r, n_s = 2048, 8192
    rk = rng.permutation(n_r).astype(np.int32)
    sk = rk[rng.randint(0, n_r, size=n_s)].astype(np.int32)
    mesh = make_mesh(8)
    agg, overflow = distributed_join_aggregate(
        jnp.asarray(rk), jnp.ones(n_r, jnp.int32),
        jnp.asarray(sk), jnp.ones(n_s, jnp.int32),
        mesh, slack=3.0,
    )
    assert int(overflow) == 0
    assert int(agg) == n_s


@needs_8
def test_two_level_exchange(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=4096, n_s=8192, dup_build=True)
    mesh = make_mesh_2d(2, 4)
    for slack in (None, 3.0):  # exact pre-pass caps AND slack-guessed caps
        agg, overflow = distributed_join_aggregate_2level(
            jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk),
            jnp.asarray(sp), mesh, slack=slack,
        )
        assert int(overflow) == 0
        assert int(agg) == oracle.join_aggregate(rk, rp, sk, sp)


@needs_8
def test_overflow_auto_replan(rng):
    """Every S key identical -> one destination bucket overflows any
    slack~1 cap. Round-2 behavior was 'count it and let the caller
    assert'; the engine now auto-replans with exact caps and returns an
    exact result (warning emitted, overflow 0)."""
    n = 4096
    rk = rng.permutation(n).astype(np.int32)
    sk = np.full(n, 7, dtype=np.int32)
    mesh = make_mesh(8)
    with pytest.warns(UserWarning, match="overflow"):
        agg, overflow = distributed_join_aggregate(
            jnp.asarray(rk), jnp.ones(n, jnp.int32),
            jnp.asarray(sk), jnp.ones(n, jnp.int32),
            mesh, slack=1.0,
        )
    assert int(overflow) == 0
    assert int(agg) == n  # key 7 exists exactly once in R


@needs_8
def test_distributed_zipf_skew(rng):
    """Distributed Zipf z=1.05 join (BASELINE config 4's skew inside the
    exchange): heavy keys funnel whole destinations onto single chips;
    exact caps absorb it and the result stays bit-exact."""
    from icde2019_gpu_join import datagen

    n_r, n_s = 8192, 32768
    rk = datagen.random_unique_gen(n_r, n_r - 1, seed=5)
    sk = datagen.gen_zipf(n_s, n_r, 1.05, seed=6)
    rp = rng.randint(1, 100, n_r).astype(np.int32)
    sp = rng.randint(1, 100, n_s).astype(np.int32)
    mesh = make_mesh(8)
    for method in ("group", "sort"):
        agg, overflow = distributed_join_aggregate(
            jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk),
            jnp.asarray(sp), mesh, method=method,
        )
        assert int(overflow) == 0
        assert int(agg) == oracle.join_aggregate(rk, rp, sk, sp)


def test_segmented_distributed_join(rng):
    """Streamed-probe distributed join (exchange/probe pipeline) matches
    the oracle and the one-shot distributed join; exact caps by default."""
    from icde2019_gpu_join.parallel.dist_join import distributed_join_segmented
    from icde2019_gpu_join.parallel.mesh import make_mesh

    nd = len(jax.devices())
    n_r, n_s = 64 * nd, 512 * nd
    rk = rng.permutation(4 * n_r)[:n_r].astype(np.int32)
    sk = rk[rng.randint(0, n_r, n_s)].astype(np.int32)
    rp = rng.randint(1, 50, n_r).astype(np.int32)
    sp = rng.randint(1, 50, n_s).astype(np.int32)
    for kwargs in (dict(), dict(slack=4.0), dict(method="sort")):
        agg, ov = distributed_join_segmented(
            jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk),
            jnp.asarray(sp), mesh=make_mesh(nd), num_segments=4, **kwargs)
        assert int(ov) == 0
        assert int(agg) == oracle.join_aggregate(rk, rp, sk, sp)


def test_plan_cap_exact(rng):
    """plan_cap returns >= the true max bucket fill, 128-rounded."""
    from icde2019_gpu_join.parallel import plan as xplan

    nd = len(jax.devices())
    n = 1024 * nd
    keys = rng.randint(0, 1 << 20, n).astype(np.int32)
    mesh = make_mesh(nd)
    cap = xplan.plan_cap(jnp.asarray(keys), mesh, "x", nd, 0)
    # host recompute: per-shard destination histogram
    pid = oracle.partition_ids(keys, max((nd - 1).bit_length(), 1), 0)
    mx = 0
    for c in range(nd):
        shard = pid[c * (n // nd):(c + 1) * (n // nd)]
        mx = max(mx, np.bincount(shard, minlength=nd).max())
    assert cap >= mx
    assert cap % 128 == 0
    assert cap <= mx + 128


def test_bucket_frames_roundtrip(rng):
    """partition_to_buckets preserves the payload!=0 row multiset, obeys
    metadata (start/count), and never overflows with an exact cap."""
    from icde2019_gpu_join.parallel.exchange import (
        frames_valid_mask, partition_to_buckets, partition_to_buckets_grouped)

    n, nd = 5000, 8
    keys = rng.randint(0, 1 << 20, n).astype(np.int32)
    pays = rng.randint(1, 1000, n).astype(np.int32)
    pid = oracle.partition_ids(keys, 3, 0)
    cap = int(-(-np.bincount(pid, minlength=nd).max() // 128) * 128)

    fr = partition_to_buckets(jnp.asarray(keys), jnp.asarray(pays), nd,
                              cap, 0)
    assert int(fr.overflow) == 0
    k2 = np.asarray(fr.keys)
    p2 = np.asarray(fr.pays)
    st, ct = np.asarray(fr.start), np.asarray(fr.count)
    assert np.array_equal(ct, np.bincount(pid, minlength=nd))
    # valid rows per bucket live exactly at [start, start+count)
    mask = np.asarray(frames_valid_mask(fr.start, fr.count, k2.shape[1]))
    live = np.stack([k2[mask], p2[mask]], axis=1)
    orig = np.stack([keys, pays], axis=1)
    assert np.array_equal(
        live[np.lexsort((live[:, 1], live[:, 0]))],
        orig[np.lexsort((orig[:, 1], orig[:, 0]))])
    # rows outside the mask are payload-0
    assert np.all(p2[~mask] == 0)
    # per-bucket destination correctness
    for d in range(nd):
        assert np.all(oracle.partition_ids(k2[d][mask[d]], 3, 0) == d)

    # grouped variant: same live multiset (block-cap from the exact helper)
    from icde2019_gpu_join.ops.bits import rotate_keys
    from icde2019_gpu_join.ops.partition_radix import grouped_block_counts

    pb = np.asarray(grouped_block_counts(
        rotate_keys(jnp.asarray(keys), 3, 0), 3, 1024))
    gcap = int(pb.max()) * 128
    fg = partition_to_buckets_grouped(jnp.asarray(keys), jnp.asarray(pays),
                                      nd, gcap, 0, chunk=1024)
    assert int(fg.overflow) == 0
    kg, pg = np.asarray(fg.keys), np.asarray(fg.pays)
    liveg = pg != 0
    got = np.stack([kg[liveg], pg[liveg]], axis=1)
    assert np.array_equal(
        got[np.lexsort((got[:, 1], got[:, 0]))],
        orig[np.lexsort((orig[:, 1], orig[:, 0]))])
    for d in range(nd):
        assert np.all(oracle.partition_ids(kg[d][liveg[d]], 3, 0) == d)


def test_bucket_frames_single_bucket(rng):
    """num_buckets=1 regression (round-3 advisor, high): a 1-device mesh
    must not reshape a 2-group sort into a 1-bucket frame. Both bucketing
    methods must return one frame holding the full live multiset, and
    distributed_join_aggregate on a 1-device mesh must run end-to-end."""
    from icde2019_gpu_join.parallel.exchange import (
        frames_valid_mask, partition_to_buckets, partition_to_buckets_grouped)

    n = 5000
    keys = rng.randint(0, 1 << 20, n).astype(np.int32)
    pays = rng.randint(1, 1000, n).astype(np.int32)
    cap = int(-(-n // 128) * 128)
    orig = np.stack([keys, pays], axis=1)
    orig = orig[np.lexsort((orig[:, 1], orig[:, 0]))]

    fr = partition_to_buckets(jnp.asarray(keys), jnp.asarray(pays), 1, cap, 0)
    assert fr.keys.shape[0] == 1 and int(fr.overflow) == 0
    assert int(fr.count[0]) == n
    mask = np.asarray(frames_valid_mask(fr.start, fr.count, fr.keys.shape[1]))
    live = np.stack([np.asarray(fr.keys)[mask], np.asarray(fr.pays)[mask]],
                    axis=1)
    assert np.array_equal(live[np.lexsort((live[:, 1], live[:, 0]))], orig)

    # valid-aware: invalid rows never ride as live rows
    valid = rng.rand(n) < 0.5
    frv = partition_to_buckets(jnp.asarray(keys), jnp.asarray(pays), 1, cap,
                               0, valid=jnp.asarray(valid))
    assert int(frv.overflow) == 0
    assert int(frv.count[0]) == int(valid.sum())
    mv = np.asarray(frames_valid_mask(frv.start, frv.count,
                                      frv.keys.shape[1]))
    lv = np.stack([np.asarray(frv.keys)[mv], np.asarray(frv.pays)[mv]],
                  axis=1)
    ov = np.stack([keys[valid], pays[valid]], axis=1)
    assert np.array_equal(
        lv[np.lexsort((lv[:, 1], lv[:, 0]))],
        ov[np.lexsort((ov[:, 1], ov[:, 0]))])

    fg = partition_to_buckets_grouped(jnp.asarray(keys), jnp.asarray(pays),
                                      1, cap, 0)
    assert fg.keys.shape[0] == 1 and int(fg.overflow) == 0
    pg = np.asarray(fg.pays)[0]
    kg = np.asarray(fg.keys)[0]
    liveg = pg != 0
    got = np.stack([kg[liveg], pg[liveg]], axis=1)
    assert np.array_equal(got[np.lexsort((got[:, 1], got[:, 0]))], orig)


def test_distributed_aggregate_one_device(rng):
    """Config-5 leg A shape: the distributed pipeline on a 1-device mesh
    (the round-3 regression's exact failing call)."""
    rk, rp, sk, sp = make_tables(rng, n_r=1024, n_s=4096, dup_build=True)
    mesh = make_mesh(1)
    for method in ("group", "sort"):
        agg, overflow = distributed_join_aggregate(
            jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk),
            jnp.asarray(sp), mesh, method=method)
        assert int(overflow) == 0
        assert int(agg) == oracle.join_aggregate(rk, rp, sk, sp)


@needs_8
def test_heavy_split_single_dominant_key(rng):
    """North-star skew mandate: one key carries 50% of S. The PRPD heavy
    split must (a) detect it, (b) keep the result bit-exact (including a
    duplicated R key on the hot value), (c) project per-chip probe load
    within 2x of the uniform share, and (d) actually be the path
    distributed_join_segmented takes."""
    from icde2019_gpu_join.parallel import dist_join, plan as xplan

    n_r, n_s, nd = 2048, 16384, 8
    rk = rng.permutation(n_r).astype(np.int32)
    hot = int(rk[13])
    # duplicate the hot key (and a few others) in R: replicated-R
    # multiplicity must be preserved by the split
    rk[100] = hot
    rk[200] = hot
    rp = rng.randint(1, 1000, n_r).astype(np.int32)
    sk = np.where(rng.rand(n_s) < 0.5, hot,
                  rk[rng.randint(0, n_r, n_s)]).astype(np.int32)
    sp = rng.randint(1, 1000, n_s).astype(np.int32)
    want = oracle.join_aggregate(rk, rp, sk, sp)
    mesh = make_mesh(nd)

    hplan = xplan.plan_heavy_split(jnp.asarray(rk), jnp.asarray(sk), mesh,
                                   "x", nd, segments=4)
    assert hplan.split, "50%-one-key S must trigger the split"
    uniform = n_s / nd
    assert hplan.load_rows.max() <= 2.0 * uniform, (
        f"projected spread {hplan.load_rows.max() / uniform:.2f}x")

    dist_join._heavy_segmented_fn.cache_clear()
    agg, ov = dist_join.distributed_join_segmented(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh, num_segments=4)
    assert int(ov) == 0
    assert int(agg) == want
    assert dist_join._heavy_segmented_fn.cache_info().misses >= 1, (
        "heavy-split path was not taken")


@needs_8
def test_heavy_split_adversarial_zipf(rng):
    """z=1.6 Zipf probe keys at 8 devices: real concentration (top key
    ~30%+). Bit-exact through the auto split path."""
    from icde2019_gpu_join.parallel import dist_join

    n_r, n_s, nd = 4096, 32768, 8
    rk = rng.permutation(n_r).astype(np.int32)
    rp = rng.randint(1, 1000, n_r).astype(np.int32)
    idx = (np.random.default_rng(7).zipf(1.6, n_s) - 1) % n_r
    sk = rk[idx].astype(np.int32)
    sp = rng.randint(1, 1000, n_s).astype(np.int32)
    want = oracle.join_aggregate(rk, rp, sk, sp)
    mesh = make_mesh(nd)
    agg, ov = dist_join.distributed_join_segmented(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh, num_segments=4)
    assert int(ov) == 0
    assert int(agg) == want


@needs_8
def test_heavy_split_uniform_is_noop(rng):
    """Uniform keys must NOT take the split path (coarse check passes) and
    stay bit-exact on the normal pipeline."""
    from icde2019_gpu_join.parallel import dist_join

    rk, rp, sk, sp = make_tables(rng, n_r=4096, n_s=16384, dup_build=True)
    mesh = make_mesh(8)
    dist_join._heavy_segmented_fn.cache_clear()
    agg, ov = dist_join.distributed_join_segmented(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh, num_segments=4)
    assert int(ov) == 0
    assert int(agg) == oracle.join_aggregate(rk, rp, sk, sp)
    assert dist_join._heavy_segmented_fn.cache_info().misses == 0


@needs_8
def test_distributed_materialize_matches_oracle(rng):
    """Distributed materialization (north star: bit-identical 'join results
    and aggregates'): the union of per-chip output buffers is exactly the
    oracle's (Pr, Ps) match multiset; per-chip totals sum to the match
    count; pad rows exchanged between chips never materialize."""
    from icde2019_gpu_join.parallel import distributed_join_materialize

    n_r, n_s, nd = 4096, 16384, 8
    rk = rng.randint(0, 2 * n_r, n_r).astype(np.int32)
    sk = rk[rng.randint(0, n_r, n_s)].astype(np.int32)
    sk[rng.randint(0, n_s, n_s // 4)] = rng.randint(
        2 * n_r, 4 * n_r, n_s // 4).astype(np.int32)  # some non-matching
    rp = rng.randint(1, 1000, n_r).astype(np.int32)
    sp = rng.randint(1, 1000, n_s).astype(np.int32)
    expect = oracle.join_materialize(rk, rp, sk, sp)
    mesh = make_mesh(nd)
    cap = -(-(expect.shape[0] // nd + 4096) // 128) * 128
    out_r, out_s, totals, ov = distributed_join_materialize(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh, capacity_per_chip=cap)
    assert int(ov) == 0
    totals = np.asarray(totals)
    pairs = np.stack([np.asarray(out_r), np.asarray(out_s)], axis=1)
    # per-chip live slots are [0, total); everything else must be zeroed
    live = np.zeros(nd * cap, bool)
    for d in range(nd):
        assert totals[d] <= cap, "capacity heuristic too small for test"
        live[d * cap: d * cap + totals[d]] = True
    assert not np.any(pairs[~live]), "dead slots must be zero"
    assert int(totals.sum()) == expect.shape[0]
    got = pairs[live]
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    assert np.array_equal(got, expect)


@needs_8
def test_distributed_materialize_truncates(rng):
    """wrap=False with a tiny per-chip capacity: totals still report the
    TRUE per-chip match counts and every emitted pair is a real match."""
    from icde2019_gpu_join.parallel import distributed_join_materialize

    n_r, n_s, nd = 1024, 8192, 8
    rk = rng.permutation(n_r).astype(np.int32)
    sk = rk[rng.randint(0, n_r, n_s)].astype(np.int32)
    rp = rng.randint(1, 1000, n_r).astype(np.int32)
    sp = rng.randint(1, 1000, n_s).astype(np.int32)
    expect = oracle.join_materialize(rk, rp, sk, sp)
    expect_set = set(map(tuple, expect.tolist()))
    mesh = make_mesh(nd)
    cap = 256
    out_r, out_s, totals, ov = distributed_join_materialize(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh, capacity_per_chip=cap, wrap=False)
    assert int(ov) == 0
    assert int(np.asarray(totals).sum()) == n_s  # PK-FK: one match per S row
    pairs = np.stack([np.asarray(out_r), np.asarray(out_s)], axis=1)
    pairs = pairs[(pairs[:, 0] != 0) | (pairs[:, 1] != 0)]
    assert pairs.shape[0] > 0
    for pr, ps in pairs.tolist():
        assert (pr, ps) in expect_set


@needs_8
@pytest.mark.parametrize("seed", range(5))
def test_distributed_segmented_fuzz_vs_host_oracle(seed):
    """Randomized sweep of the DEFAULT distributed pipeline (segmented,
    exact caps, PRPD heavy-split auto-detection) against the independent
    C++ host oracle: dup-heavy / full-domain / skew-concentrated keys and
    full-range payloads (mod-2^32 wraparound through the exchange). Keys
    stay within the engine key-domain contract (>= 0; relation.py)."""
    from icde2019_gpu_join import datagen
    from icde2019_gpu_join.parallel.dist_join import (
        distributed_join_segmented)

    g = np.random.default_rng(4000 + seed)
    n_r, n_s = 4096, 16384  # fixed shapes: one compile across the sweep
    if seed == 0:    # dup-heavy both sides
        rk = g.integers(0, 500, n_r).astype(np.int32)
        sk = g.integers(0, 500, n_s).astype(np.int32)
    elif seed == 1:  # full non-negative int32 domain
        rk = g.integers(0, 2**31, n_r).astype(np.int64).astype(np.int32)
        sk = g.integers(0, 2**31, n_s).astype(np.int64).astype(np.int32)
    elif seed == 2:  # 30% of S on one key (heavy-split territory)
        rk = g.permutation(n_r).astype(np.int32)
        sk = np.where(g.random(n_s) < 0.3, rk[3],
                      rk[g.integers(0, n_r, n_s)]).astype(np.int32)
    elif seed == 3:  # disjoint domains: zero matches
        rk = g.integers(0, 10_000, n_r).astype(np.int32)
        sk = g.integers(20_000, 30_000, n_s).astype(np.int32)
    else:            # key-domain boundaries (incl. INT32_MAX, which the
        # 1-bucket grouped frame once mistook for padding)
        pool = np.array([0, 1, 2, 42, 2**31 - 2, 2**31 - 1], np.int32)
        rk = pool[g.integers(0, pool.size, n_r)]
        sk = pool[g.integers(0, pool.size, n_s)]
    rp = g.integers(-2**31, 2**31, n_r).astype(np.int64).astype(np.int32)
    sp = g.integers(-2**31, 2**31, n_s).astype(np.int64).astype(np.int32)

    mesh = make_mesh(8)
    agg, overflow = distributed_join_segmented(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh=mesh, num_segments=4)
    expect = datagen.host_oracle_aggregate(rk, rp, sk, sp)
    assert int(overflow) == 0
    assert int(agg) == expect, f"seed={seed}"


def test_one_device_exchange_int32max_key(rng):
    """Regression (round-4 review): the 1-bucket grouped frame tested raw
    keys against the pad sentinel, so a real key of 2^31-1 — non-negative,
    IN the engine key domain — was treated as padding and its payload
    zeroed on a 1-device mesh (the config-5 leg-A path), silently
    diverging from the multi-device result. Liveness is positional now."""
    n = 256
    rk = np.arange(n, dtype=np.int32)
    rk[7] = 2**31 - 1
    sk = np.full(n, 2**31 - 1, np.int32)
    mesh = make_mesh(1)
    for method in ("group", "sort"):
        agg, ov = distributed_join_aggregate(
            jnp.asarray(rk), jnp.ones(n, jnp.int32),
            jnp.asarray(sk), jnp.ones(n, jnp.int32),
            mesh, method=method)
        assert int(ov) == 0
        assert int(agg) == n, method


@needs_8
def test_heavy_split_executed_balance(rng):
    """Round-4 verdict item 6: assert EXECUTED balance, not planned — pull
    the actual per-chip probe loads out of the exchange metadata and check
    (a) they equal the plan's projection and (b) spread <= 2x uniform,
    while the same data WITHOUT the split leaves >2x on one chip."""
    from icde2019_gpu_join.parallel import dist_join, plan as xplan

    n_r, n_s, nd = 2048, 16384, 8
    rk = rng.permutation(n_r).astype(np.int32)
    hot = int(rk[13])
    sk = np.where(rng.rand(n_s) < 0.5, hot,
                  rk[rng.randint(0, n_r, n_s)]).astype(np.int32)
    rp = rng.randint(1, 1000, n_r).astype(np.int32)
    sp = rng.randint(1, 1000, n_s).astype(np.int32)
    want = oracle.join_aggregate(rk, rp, sk, sp)
    mesh = make_mesh(nd)
    uniform = n_s / nd

    hplan = xplan.plan_heavy_split(jnp.asarray(rk), jnp.asarray(sk), mesh,
                                   "x", nd, segments=4)
    agg, ov, loads = dist_join.distributed_join_segmented(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh, num_segments=4, return_loads=True)
    assert int(ov) == 0 and int(agg) == want
    assert loads.sum() == n_s, "every probe row processed exactly once"
    assert np.array_equal(loads, hplan.load_rows), (
        f"executed {loads} != planned {hplan.load_rows}")
    assert loads.max() <= 2.0 * uniform, (
        f"executed spread {loads.max() / uniform:.2f}x")

    # control: split disabled -> the hot destination's chip takes >2x
    agg0, ov0, loads0 = dist_join.distributed_join_segmented(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh, num_segments=4, split_heavy=False, return_loads=True)
    assert int(ov0) == 0 and int(agg0) == want
    assert loads0.sum() == n_s
    assert loads0.max() > 2.0 * uniform, "control should be imbalanced"


@needs_8
def test_heavy_split_2level_dominant_key(rng):
    """PRPD heavy split composed with the 2-level (DCN x ICI) exchange
    (round-4 verdict item 5): 50%-one-key S through a 2x4 mesh stays
    bit-exact, takes the heavy path, and the EXECUTED per-chip load is
    within 2x uniform (without the split it lands >2x on one chip)."""
    from icde2019_gpu_join.parallel import dist_join

    n_r, n_s = 2048, 16384
    rk = rng.permutation(n_r).astype(np.int32)
    hot = int(rk[77])
    rk[300] = hot  # duplicated hot build key: multiplicity must survive
    sk = np.where(rng.rand(n_s) < 0.5, hot,
                  rk[rng.randint(0, n_r, n_s)]).astype(np.int32)
    rp = rng.randint(1, 1000, n_r).astype(np.int32)
    sp = rng.randint(1, 1000, n_s).astype(np.int32)
    want = oracle.join_aggregate(rk, rp, sk, sp)
    mesh = make_mesh_2d(2, 4)
    uniform = n_s / 8

    dist_join._two_level_heavy_fn.cache_clear()
    agg, ov, loads = distributed_join_aggregate_2level(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh, return_loads=True)
    assert int(ov) == 0
    assert int(agg) == want
    assert dist_join._two_level_heavy_fn.cache_info().misses >= 1, (
        "2-level heavy-split path was not taken")
    assert loads.sum() == n_s
    assert loads.max() <= 2.0 * uniform, (
        f"executed spread {loads.max() / uniform:.2f}x")

    agg0, ov0, loads0 = distributed_join_aggregate_2level(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh, split_heavy=False, return_loads=True)
    assert int(ov0) == 0 and int(agg0) == want
    assert loads0.max() > 2.0 * uniform, "control should be imbalanced"


@needs_8
def test_heavy_split_2level_uniform_noop(rng):
    """Uniform keys must not trigger the 2-level heavy path."""
    from icde2019_gpu_join.parallel import dist_join

    rk, rp, sk, sp = make_tables(rng, n_r=4096, n_s=8192, dup_build=True)
    mesh = make_mesh_2d(2, 4)
    dist_join._two_level_heavy_fn.cache_clear()
    agg, ov = distributed_join_aggregate_2level(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh)
    assert int(ov) == 0
    assert int(agg) == oracle.join_aggregate(rk, rp, sk, sp)
    assert dist_join._two_level_heavy_fn.cache_info().misses == 0


@needs_8
def test_heavy_split_materialize_dominant_key(rng):
    """PRPD heavy split on the MATERIALIZE pipeline (round-4 verdict item
    5): with a 50%-one-key S, the output multiset across chips must equal
    the oracle's exactly, no chip's ring may absorb the whole hot key
    (per-chip totals <= 2x uniform matches), and without the split the
    owner chip provably takes >2x."""
    from icde2019_gpu_join.parallel import dist_join
    from icde2019_gpu_join.parallel.dist_join import (
        distributed_join_materialize)

    n_r, n_s, nd = 2048, 16384, 8
    rk = rng.permutation(n_r).astype(np.int32)
    hot = int(rk[55])
    sk = np.where(rng.rand(n_s) < 0.5, hot,
                  rk[rng.randint(0, n_r, n_s)]).astype(np.int32)
    rp = rng.randint(1, 1000, n_r).astype(np.int32)
    sp = rng.randint(1, 1000, n_s).astype(np.int32)
    expect = oracle.join_materialize(rk, rp, sk, sp)  # n_s rows (PK build)
    mesh = make_mesh(nd)
    uniform = expect.shape[0] / nd
    cap = -(-int(2.0 * uniform) // 128) * 128

    dist_join._materialize_heavy_fn.cache_clear()
    out_r, out_s, totals, ov = distributed_join_materialize(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh, capacity_per_chip=cap)
    assert int(ov) == 0
    assert dist_join._materialize_heavy_fn.cache_info().misses >= 1, (
        "materialize heavy-split path was not taken")
    totals = np.asarray(totals)
    assert int(totals.sum()) == expect.shape[0]
    assert totals.max() <= 2.0 * uniform, (
        f"materialized spread {totals.max() / uniform:.2f}x")
    pairs = np.stack([np.asarray(out_r), np.asarray(out_s)], axis=1)
    live = np.zeros(nd * cap, bool)
    for d in range(nd):
        assert totals[d] <= cap, "ring must not wrap in this test"
        live[d * cap: d * cap + totals[d]] = True
    assert not np.any(pairs[~live]), "dead slots must be zero"
    got = pairs[live]
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    assert np.array_equal(got, expect)

    # control: split disabled -> the hot key's owner chip takes >2x (its
    # ring wraps at this capacity, so only compare totals, not contents)
    _, _, totals0, ov0 = distributed_join_materialize(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh, capacity_per_chip=cap, split_heavy=False)
    assert int(ov0) == 0
    totals0 = np.asarray(totals0)
    assert int(totals0.sum()) == expect.shape[0]
    assert totals0.max() > 2.0 * uniform, "control should be imbalanced"


@needs_8
@pytest.mark.parametrize("seed", range(4))
def test_distributed_2level_fuzz_vs_host_oracle(seed):
    """Randomized sweep of the 2-level pipeline (exact caps + PRPD
    heavy-split auto-detection) against the independent C++ host oracle,
    same adversarial families as the segmented fuzz."""
    from icde2019_gpu_join import datagen

    g = np.random.default_rng(5000 + seed)
    n_r, n_s = 4096, 16384
    if seed == 0:    # dup-heavy both sides
        rk = g.integers(0, 500, n_r).astype(np.int32)
        sk = g.integers(0, 500, n_s).astype(np.int32)
    elif seed == 1:  # full non-negative int32 domain
        rk = g.integers(0, 2**31, n_r).astype(np.int64).astype(np.int32)
        sk = g.integers(0, 2**31, n_s).astype(np.int64).astype(np.int32)
    elif seed == 2:  # 40% of S on one key -> heavy path through 2 levels
        rk = g.permutation(n_r).astype(np.int32)
        sk = np.where(g.random(n_s) < 0.4, rk[3],
                      rk[g.integers(0, n_r, n_s)]).astype(np.int32)
    else:            # key-domain boundaries
        pool = np.array([0, 1, 2, 42, 2**31 - 2, 2**31 - 1], np.int32)
        rk = pool[g.integers(0, pool.size, n_r)]
        sk = pool[g.integers(0, pool.size, n_s)]
    rp = g.integers(-2**31, 2**31, n_r).astype(np.int64).astype(np.int32)
    sp = g.integers(-2**31, 2**31, n_s).astype(np.int64).astype(np.int32)

    mesh = make_mesh_2d(2, 4)
    agg, overflow = distributed_join_aggregate_2level(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh)
    expect = datagen.host_oracle_aggregate(rk, rp, sk, sp)
    assert int(overflow) == 0
    assert int(agg) == expect, f"seed={seed}"


@needs_8
@pytest.mark.parametrize("seed", range(3))
def test_distributed_materialize_fuzz_multiset(seed):
    """Randomized sweep of distributed materialization (incl. the heavy
    path when skew trips the auto check): the union of per-chip rings is
    exactly the oracle's (Pr, Ps) multiset."""
    from icde2019_gpu_join.parallel.dist_join import (
        distributed_join_materialize)

    g = np.random.default_rng(6000 + seed)
    n_r, n_s, nd = 2048, 8192, 8
    if seed == 0:    # dup build keys (multi-match)
        rk = g.integers(0, 600, n_r).astype(np.int32)
        sk = g.integers(0, 1200, n_s).astype(np.int32)
    elif seed == 1:  # 40% of S on one key -> heavy materialize path
        rk = g.permutation(n_r).astype(np.int32)
        sk = np.where(g.random(n_s) < 0.4, rk[9],
                      rk[g.integers(0, n_r, n_s)]).astype(np.int32)
    else:            # sparse matches
        rk = g.integers(0, 1 << 20, n_r).astype(np.int32)
        sk = g.integers(0, 1 << 20, n_s).astype(np.int32)
    rp = g.integers(1, 1000, n_r).astype(np.int32)
    sp = g.integers(1, 1000, n_s).astype(np.int32)
    expect = oracle.join_materialize(rk, rp, sk, sp)
    mesh = make_mesh(nd)
    cap = max(256, -(-2 * max(expect.shape[0], 1) // (nd * 128)) * 128)
    out_r, out_s, totals, ov = distributed_join_materialize(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        mesh, capacity_per_chip=cap)
    assert int(ov) == 0
    totals = np.asarray(totals)
    assert int(totals.sum()) == expect.shape[0], f"seed={seed}"
    pairs = np.stack([np.asarray(out_r), np.asarray(out_s)], axis=1)
    live = np.zeros(nd * cap, bool)
    for d in range(nd):
        assert totals[d] <= cap, f"seed={seed}: ring wrapped"
        live[d * cap: d * cap + totals[d]] = True
    assert not np.any(pairs[~live])
    got = pairs[live]
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    assert np.array_equal(got, expect), f"seed={seed}"
