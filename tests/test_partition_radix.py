"""ops/partition_radix.py: grouping correctness + full-sort prototype."""

import jax.numpy as jnp
import numpy as np
import pytest

from icde2019_gpu_join.ops.partition_radix import (
    radix_group, radix_sort_via_grouping)

SENT = 0x7FFFFFFF


def _check_grouping(keys, pays, bits, chunk=1024):
    g = radix_group(jnp.asarray(keys), jnp.asarray(pays), bits, chunk)
    gk = np.asarray(g.keys)
    gv = np.asarray(g.pays)
    counts = np.asarray(g.counts)
    bo = np.asarray(g.block_offsets)
    P = 1 << bits
    u = keys.view(np.uint32) ^ np.uint32(0x80000000)
    pid = (u >> np.uint32(32 - bits)).astype(np.int64)
    exp_counts = np.bincount(pid, minlength=P)
    np.testing.assert_array_equal(counts, exp_counts)
    assert counts.sum() == keys.size
    for p in range(P):
        seg_k = gk[bo[p] * 128:bo[p + 1] * 128]
        seg_v = gv[bo[p] * 128:bo[p + 1] * 128]
        m = seg_k != SENT
        # real keys equal to the sentinel are excluded from inputs by the
        # engine-wide sentinel contract
        assert m.sum() == exp_counts[p], p
        got = np.stack([seg_k[m], seg_v[m]], 1)
        em = pid == p
        exp = np.stack([keys[em], pays[em]], 1)
        got = got[np.lexsort((got[:, 1], got[:, 0]))]
        exp = exp[np.lexsort((exp[:, 1], exp[:, 0]))]
        np.testing.assert_array_equal(got, exp)
        # sentinel rows carry payload 0
        np.testing.assert_array_equal(seg_v[~m], 0)


@pytest.mark.parametrize("bits", [2, 3, 5])
def test_radix_group_uniform(rng, bits):
    n = 20_000
    keys = rng.randint(-(1 << 31), 1 << 31, n).astype(np.int32)
    keys = np.where(keys == SENT, 0, keys).astype(np.int32)
    pays = rng.randint(-100, 100, n).astype(np.int32)
    _check_grouping(keys, pays, bits)


def test_radix_group_skewed(rng):
    n = 30_000
    keys = np.concatenate([
        np.full(n // 2, 12345, np.int32),
        rng.randint(0, 1 << 10, n - n // 2).astype(np.int32),
    ])
    rng.shuffle(keys)
    pays = rng.randint(1, 50, n).astype(np.int32)
    _check_grouping(keys, pays, 3)


def test_radix_group_edge_sizes(rng):
    for n in [1, 127, 128, 129, 1023, 1025]:
        keys = rng.randint(0, 1 << 20, n).astype(np.int32)
        pays = np.arange(n, dtype=np.int32)
        _check_grouping(keys, pays, 2, chunk=512)


def test_radix_sort_via_grouping_matches_sort(rng):
    n = 50_000
    keys = rng.randint(-(1 << 31), 1 << 31 - 1, n).astype(np.int32)
    keys = np.where(keys == SENT, 0, keys).astype(np.int32)
    pays = rng.randint(0, 1 << 30, n).astype(np.int32)
    ks, vs, total, ov = radix_sort_via_grouping(
        jnp.asarray(keys), jnp.asarray(pays), bits=3, chunk=1024)
    assert int(ov) == 0
    assert int(total) == n
    ksn, vsn = np.asarray(ks), np.asarray(vs)
    m = ksn != SENT
    got_k = ksn[m]
    got_v = vsn[m]
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[order])
    # keys sorted; (k, v) multiset preserved
    got = np.stack([got_k, got_v], 1)
    exp = np.stack([keys[order], pays[order]], 1)
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    exp = exp[np.lexsort((exp[:, 1], exp[:, 0]))]
    np.testing.assert_array_equal(got, exp)


def test_radix_sort_overflow_flag(rng):
    keys = np.zeros(10_000, np.int32)   # everything in one partition
    pays = np.arange(10_000, dtype=np.int32)
    ks, vs, total, ov = radix_sort_via_grouping(
        jnp.asarray(keys), jnp.asarray(pays), bits=4, chunk=1024,
        lmax_blocks=4)
    assert int(ov) > 0
