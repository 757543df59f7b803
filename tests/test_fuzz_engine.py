"""Randomized consistency sweep: the full engine vs the independent C++
host oracle (tj_oracle_join_aggregate) across adversarial input shapes.

The reference's only correctness instrumentation is eyeballing printed
aggregates (SURVEY.md §4); this sweep is the systematic version — every
case runs the flagship banded pipeline end to end and compares the
int32-wraparound SUM(Pr*Ps) bit-exactly. The C++ oracle shares no code
with the JAX path (and no sort with the engine under test)."""

import numpy as np
import pytest

import jax.numpy as jnp

from icde2019_gpu_join import datagen
from icde2019_gpu_join.models import ClusteredJoin
from icde2019_gpu_join.relation import Relation
from icde2019_gpu_join.utils import oracle


def _expect(rk, rp, sk, sp):
    return datagen.host_oracle_aggregate(rk, rp, sk, sp)


def _keys(rng, kind, n, dom):
    """Key generators WITHIN the engine key-domain contract (keys >= 0;
    -1/-2 are reserved sentinels — relation.py, PARITY.md deviation)."""
    if kind == "unique":
        return rng.permutation(max(n, dom + 1))[:n].astype(np.int32)
    if kind == "dupes":
        return rng.integers(0, max(dom // 16, 1), n).astype(np.int32)
    if kind == "full31":  # the whole non-negative int32 range
        return rng.integers(0, 2**31, n).astype(np.int64).astype(np.int32)
    if kind == "one_key":
        return np.full(n, 42, np.int32)
    if kind == "extremes":  # domain boundaries incl. INT32_MAX
        pool = np.array([0, 1, 2, 42, 2**31 - 2, 2**31 - 1], np.int32)
        return pool[rng.integers(0, pool.size, n)]
    raise AssertionError(kind)


_KINDS = ["unique", "dupes", "full31", "one_key", "extremes"]


@pytest.mark.parametrize("seed", range(12))
def test_engine_fuzz_vs_host_oracle(seed):
    rng = np.random.default_rng(1000 + seed)
    # ONE fixed (non-128-multiple) shape pair: the sweep's variety is in
    # key DISTRIBUTIONS and payload ranges; varying sizes forced a fresh
    # XLA compile per case (~40s each on this 1-core host). Shape variety
    # is covered by the per-op suites.
    n_r, n_s = 12_201, 24_575
    dom = int(rng.integers(2, 50_000))
    rkind = _KINDS[seed % len(_KINDS)]
    skind = _KINDS[(seed // len(_KINDS)) % len(_KINDS)]
    rk = _keys(rng, rkind, n_r, dom)
    sk = _keys(rng, skind, n_s, dom)
    # full-range payloads: exercises mod-2^32 wraparound end to end
    rp = rng.integers(-2**31, 2**31, n_r).astype(np.int64).astype(np.int32)
    sp = rng.integers(-2**31, 2**31, n_s).astype(np.int64).astype(np.int32)

    res = ClusteredJoin().aggregate(
        Relation(jnp.asarray(rk), jnp.asarray(rp)),
        Relation(jnp.asarray(sk), jnp.asarray(sp)))
    expect = _expect(rk, rp, sk, sp)
    assert res.aggregate == expect, (
        f"seed={seed} kinds=({rkind},{skind}) n=({n_r},{n_s}) dom={dom}")


def test_engine_fuzz_materialize_multiset():
    """Materialized rows: multiset parity vs the numpy oracle on a
    duplicate-heavy case (canonical sort both sides)."""
    rng = np.random.default_rng(77)
    n_r, n_s, dom = 700, 1_100, 150
    rk = _keys(rng, "dupes", n_r, dom)
    sk = _keys(rng, "dupes", n_s, dom)
    rp = rng.integers(-100, 100, n_r).astype(np.int32)
    sp = rng.integers(-100, 100, n_s).astype(np.int32)
    expect_pairs = oracle.join_materialize(rk, rp, sk, sp)

    res = ClusteredJoin().materialize(
        Relation(jnp.asarray(rk), jnp.asarray(rp)),
        Relation(jnp.asarray(sk), jnp.asarray(sp)),
        capacity=max(128, 2 * expect_pairs.shape[0]))
    m = res.count
    out_r, out_s = res.pairs
    got = np.stack(
        [np.asarray(out_r)[:m], np.asarray(out_s)[:m]], axis=1)
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    assert got.shape == expect_pairs.shape
    assert np.array_equal(got, expect_pairs)


@pytest.mark.parametrize("seed", range(4))
def test_streaming_fuzz_vs_host_oracle(seed):
    """Streaming regime under adversarial inputs: segment size not dividing
    n_s, dup-heavy / full-domain keys, full-range payloads."""
    from icde2019_gpu_join.config import EngineConfig
    from icde2019_gpu_join.models.streaming import streaming_join_aggregate

    rng = np.random.default_rng(2000 + seed)
    n_r, n_s = 6_000, 19_001  # n_s prime-ish: last segment ragged
    kinds = [("unique", "dupes"), ("dupes", "dupes"),
             ("full31", "full31"), ("unique", "one_key")]
    rkind, skind = kinds[seed]
    rk = _keys(rng, rkind, n_r, 30_000)
    sk = _keys(rng, skind, n_s, 30_000)
    rp = rng.integers(-2**31, 2**31, n_r).astype(np.int64).astype(np.int32)
    sp = rng.integers(-2**31, 2**31, n_s).astype(np.int64).astype(np.int32)

    res = streaming_join_aggregate(
        Relation(rk, rp), Relation(sk, sp),
        EngineConfig(segment_rows=4_096))
    assert res.aggregate == _expect(rk, rp, sk, sp), (seed, rkind, skind)


@pytest.mark.parametrize("seed", range(3))
def test_coprocess_fuzz_vs_host_oracle(seed):
    """Coprocess regime (host pre-partition + knapsack batches + staged
    device refine) under dup-heavy and full-domain keys."""
    from icde2019_gpu_join.models.coprocess import coprocess_join_aggregate

    rng = np.random.default_rng(3000 + seed)
    n_r, n_s = 9_000, 13_000
    kinds = [("dupes", "dupes"), ("full31", "unique"), ("unique", "dupes")]
    rkind, skind = kinds[seed]
    rk = _keys(rng, rkind, n_r, 25_000)
    sk = _keys(rng, skind, n_s, 25_000)
    rp = rng.integers(-2**31, 2**31, n_r).astype(np.int64).astype(np.int32)
    sp = rng.integers(-2**31, 2**31, n_s).astype(np.int64).astype(np.int32)

    res = coprocess_join_aggregate(Relation(rk, rp), Relation(sk, sp))
    assert res.aggregate == _expect(rk, rp, sk, sp), (seed, rkind, skind)


def test_packed_sort_impl_end_to_end():
    """The packed (1-operand uint64) sort impl — the alternative to
    lax.sort — drives the full banded pipeline bit-exactly against the C++
    oracle."""
    from icde2019_gpu_join.ops import band_join as bj

    rng = np.random.default_rng(55)
    n_r, n_s = 12_201, 24_575
    rk = _keys(rng, "dupes", n_r, 40_000)
    sk = _keys(rng, "extremes", n_s, 40_000)
    rp = rng.integers(-2**31, 2**31, n_r).astype(np.int64).astype(np.int32)
    sp = rng.integers(-2**31, 2**31, n_s).astype(np.int64).astype(np.int32)
    bj.set_sort_impl("packed")
    try:
        res = ClusteredJoin().aggregate(
            Relation(jnp.asarray(rk), jnp.asarray(rp)),
            Relation(jnp.asarray(sk), jnp.asarray(sp)))
    finally:
        bj.set_sort_impl("lax")
    assert res.aggregate == _expect(rk, rp, sk, sp)
