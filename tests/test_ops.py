"""Device-op unit tests vs the numpy oracle (SURVEY.md §4 item 3)."""

import jax.numpy as jnp
import numpy as np
import pytest

from icde2019_gpu_join.ops import (
    filter_compact,
    groupby_count_sum,
    histogram,
    perfect_hash_build,
    perfect_hash_probe_aggregate,
    radix_partition,
    radix_sort,
    sort_merge_aggregate,
    sort_merge_count,
)
from icde2019_gpu_join.ops.partition import radix_partition_multipass
from icde2019_gpu_join.ops.groupby import groupby_count_sum_onehot
from icde2019_gpu_join.utils import oracle
from tests.conftest import make_tables


def test_histogram(rng):
    rk, _, _, _ = make_tables(rng, n_r=2000, n_s=10)
    h = np.asarray(histogram(jnp.asarray(rk), 6, 0))
    expect = np.bincount(oracle.partition_ids(rk, 6, 0), minlength=64)
    assert np.array_equal(h, expect)


def _canon(keys, pays):
    """Canonical (key, payload) order: payload order among duplicate keys is
    engine-unspecified (unstable sort), so compare lexsorted pairs."""
    order = np.lexsort((np.asarray(pays), np.asarray(keys).view(np.uint32)))
    return np.asarray(keys)[order], np.asarray(pays)[order]


@pytest.mark.parametrize("bits,first_bit", [(4, 0), (8, 0), (6, 3), (13, 0)])
def test_radix_partition_matches_oracle(rng, bits, first_bit):
    rk, rp, _, _ = make_tables(rng, n_r=3000, n_s=10, dup_build=True)
    got = radix_partition(jnp.asarray(rk), jnp.asarray(rp), bits, first_bit)
    ek, ep, ec, eo = oracle.radix_partition(rk, rp, bits, first_bit)
    assert np.array_equal(np.asarray(got.keys), ek)
    gk, gp = _canon(got.keys, got.payload)
    xk, xp = _canon(ek, ep)
    assert np.array_equal(gk, xk) and np.array_equal(gp, xp)
    assert np.array_equal(np.asarray(got.counts), ec)
    assert np.array_equal(np.asarray(got.offsets), eo)


def test_multipass_matches_singlepass(rng):
    rk, rp, _, _ = make_tables(rng, n_r=3000, n_s=10, dup_build=True)
    one = radix_partition(jnp.asarray(rk), jnp.asarray(rp), 13, 0)
    multi = radix_partition_multipass(jnp.asarray(rk), jnp.asarray(rp), 13, 0, 5)
    assert np.array_equal(np.asarray(one.keys), np.asarray(multi.keys))
    ok, op = _canon(one.keys, one.payload)
    mk, mp = _canon(multi.keys, multi.payload)
    assert np.array_equal(ok, mk) and np.array_equal(op, mp)
    assert np.array_equal(np.asarray(one.counts), np.asarray(multi.counts))


def test_partition_negative_keys():
    # uint32 radix semantics: -1 goes to the all-ones partition
    keys = jnp.asarray(np.array([-1, 0, 5, -8, 7], dtype=np.int32))
    pays = jnp.arange(5, dtype=jnp.int32)
    got = radix_partition(keys, pays, 3, 0)
    order = np.argsort(oracle.rotate_keys(np.asarray(keys), 3, 0), kind="stable")
    assert np.array_equal(np.asarray(got.keys), np.asarray(keys)[order])


def test_sort_merge_aggregate(rng):
    rk, rp, sk, sp = make_tables(rng, dup_build=True)
    got = int(sort_merge_aggregate(jnp.asarray(rk), jnp.asarray(rp),
                                   jnp.asarray(sk), jnp.asarray(sp)))
    assert got == oracle.join_aggregate(rk, rp, sk, sp)
    assert int(sort_merge_count(jnp.asarray(rk), jnp.asarray(sk))) == oracle.join_count(rk, sk)


def test_perfect_hash_join(rng):
    n_r, n_s = 1000, 5000
    rk = rng.permutation(n_r).astype(np.int32)
    rp = rng.randint(-(2**31), 2**31, size=n_r).astype(np.int64).astype(np.int32)
    sk = rk[rng.randint(0, n_r, size=n_s)].astype(np.int32)
    sp = rng.randint(-(2**31), 2**31, size=n_s).astype(np.int64).astype(np.int32)
    table = perfect_hash_build(jnp.asarray(rk), jnp.asarray(rp), n_r)
    got = int(perfect_hash_probe_aggregate(table, jnp.asarray(sk), jnp.asarray(sp)))
    assert got == oracle.join_aggregate(rk, rp, sk, sp)


def test_filter(rng):
    rk, rp, _, _ = make_tables(rng, n_r=2000, n_s=10, dup_build=True)
    keys_c, vals_c, count = filter_compact(jnp.asarray(rk), jnp.asarray(rp), 100, 900)
    ek, ev = oracle.filter_rows(rk, rp, 100, 900)
    c = int(count)
    assert c == ek.shape[0]
    assert np.array_equal(np.asarray(keys_c)[:c], ek)
    assert np.array_equal(np.asarray(vals_c)[:c], ev)


def test_groupby(rng):
    g = rng.randint(0, 64, size=5000).astype(np.int32)
    v = rng.randint(-(2**31), 2**31, size=5000).astype(np.int64).astype(np.int32)
    cnt, sums = groupby_count_sum(jnp.asarray(g), jnp.asarray(v), 64)
    ec, es = oracle.groupby_aggregate(g, v, 64)
    assert np.array_equal(np.asarray(cnt), ec)
    assert np.array_equal(np.asarray(sums), es)


def test_groupby_onehot_counts(rng):
    g = rng.randint(0, 32, size=4096).astype(np.int32)
    v = rng.randint(0, 1000, size=4096).astype(np.int32)
    cnt, sums = groupby_count_sum_onehot(jnp.asarray(g), jnp.asarray(v), 32)
    ec, es = oracle.groupby_aggregate(g, v, 32)
    assert np.array_equal(np.asarray(cnt), ec)
    assert np.array_equal(np.asarray(sums), es)


def test_radix_sort(rng):
    rk, rp, _, _ = make_tables(rng, n_r=4000, n_s=10, dup_build=True)
    ks, ps = radix_sort(jnp.asarray(rk), jnp.asarray(rp))
    order = np.argsort(rk.view(np.uint32), kind="stable")
    assert np.array_equal(np.asarray(ks), rk[order])
    assert np.array_equal(np.asarray(ps), rp[order])
    # multi-pass composition agrees
    ks2, ps2 = radix_sort(jnp.asarray(rk), jnp.asarray(rp), bits=32, lsb_first_passes=4)
    assert np.array_equal(np.asarray(ks2), np.asarray(ks))
    assert np.array_equal(np.asarray(ps2), np.asarray(ps))


def test_debug_validators(rng):
    from icde2019_gpu_join.utils import debug
    from icde2019_gpu_join.ops.band_join import sort_by_key

    rk, rp, _, _ = make_tables(rng, n_r=2000, n_s=10, dup_build=True)
    rel = radix_partition(jnp.asarray(rk), jnp.asarray(rp), 5, 0)
    debug.validate_partition(rel, rk, rp)
    sv, _ = sort_by_key(jnp.asarray(rk), jnp.asarray(rp))
    debug.validate_sorted(sv)


def test_key_domain_validator():
    import os
    import pytest as _pytest
    from icde2019_gpu_join.utils.debug import validate_key_domain
    from icde2019_gpu_join.relation import Relation

    validate_key_domain(np.arange(10, dtype=np.int32))
    with _pytest.raises(ValueError):
        validate_key_domain(np.array([3, -1, 5], np.int32))
    os.environ["JOIN_DEBUG"] = "1"
    try:
        with _pytest.raises(ValueError):
            Relation(jnp.asarray(np.array([-5], np.int32)))
        Relation(jnp.asarray(np.array([5], np.int32)))
    finally:
        del os.environ["JOIN_DEBUG"]
