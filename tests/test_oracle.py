"""Oracle self-consistency (SURVEY.md §4 gate 1)."""

import numpy as np

from icde2019_gpu_join.utils import oracle
from tests.conftest import make_tables


def brute_force_aggregate(rk, rp, sk, sp):
    total = np.uint32(0)
    for i in range(rk.shape[0]):
        for j in range(sk.shape[0]):
            if rk[i] == sk[j]:
                total += np.uint32(rp[i]) * np.uint32(sp[j])
    return int(total.view(np.int32))


def test_join_aggregate_matches_bruteforce(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=40, n_s=120, key_range=60, dup_build=True)
    assert oracle.join_aggregate(rk, rp, sk, sp) == brute_force_aggregate(rk, rp, sk, sp)


def test_join_count_pkfk(rng):
    # PK-FK with payloads=1: aggregate == count == |matching S rows|
    rk = rng.permutation(1000)[:500].astype(np.int32)
    sk = rk[rng.randint(0, 500, size=2000)].astype(np.int32)
    ones_r = np.ones(500, np.int32)
    ones_s = np.ones(2000, np.int32)
    assert oracle.join_count(rk, sk) == 2000
    assert oracle.join_aggregate(rk, ones_r, sk, ones_s) == 2000


def test_materialize_multiset(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=30, n_s=90, key_range=40, dup_build=True)
    pairs = oracle.join_materialize(rk, rp, sk, sp)
    assert pairs.shape[0] == oracle.join_count(rk, sk)
    # aggregate recomputed from pairs must agree
    agg = np.uint32(
        np.sum(pairs[:, 0].astype(np.uint32) * pairs[:, 1].astype(np.uint32), dtype=np.uint64)
    )
    assert int(agg.view(np.int32)) == oracle.join_aggregate(rk, rp, sk, sp)


def test_radix_partition_bijection(rng):
    rk, rp, _, _ = make_tables(rng, n_r=500, n_s=10)
    keys, pays, counts, offsets = oracle.radix_partition(rk, rp, 5, 0)
    assert counts.sum() == rk.shape[0]
    assert np.array_equal(np.sort(keys), np.sort(rk))
    p = oracle.partition_ids(keys, 5, 0)
    assert np.all(np.diff(p) >= 0)  # grouped
    # payload follows its key
    assert set(zip(keys.tolist(), pays.tolist())) == set(zip(rk.tolist(), rp.tolist()))


def test_groupby(rng):
    g = rng.randint(0, 16, size=1000)
    v = rng.randint(-100, 100, size=1000).astype(np.int32)
    cnt, sums = oracle.groupby_aggregate(g, v, 16)
    assert cnt.sum() == 1000
    for grp in range(16):
        assert sums[grp] == np.int32(np.sum(v[g == grp], dtype=np.int64) & 0xFFFFFFFF)


def test_create_relation_n_tiling():
    from icde2019_gpu_join.utils import datasets

    base = np.arange(5, dtype=np.int32)
    out = datasets.create_relation_n(base, 3)
    assert np.array_equal(out, np.tile(base, 3))
