"""End-to-end join strategies vs oracle (ClusteredJoin, streaming, coprocess,
dispatcher)."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from icde2019_gpu_join.config import EngineConfig
from icde2019_gpu_join.models import ClusteredJoin, clustered_probe_join
from icde2019_gpu_join.models.coprocess import coprocess_join_aggregate
from icde2019_gpu_join.models.streaming import streaming_join_aggregate
from icde2019_gpu_join.relation import Relation
from icde2019_gpu_join.utils import oracle
from tests.conftest import make_tables


def small_cfg(**kw):
    return EngineConfig(probe_tile_r=64, probe_tile_s=64, **kw)


def as_rel(k, p):
    return Relation(jnp.asarray(k), jnp.asarray(p))


def test_clustered_join_aggregate(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=4000, n_s=12000, dup_build=True)
    res = ClusteredJoin(small_cfg()).aggregate(as_rel(rk, rp), as_rel(sk, sp))
    assert res.aggregate == oracle.join_aggregate(rk, rp, sk, sp)


def test_clustered_join_count_pkfk(rng):
    n_r, n_s = 1024, 16384
    rk = rng.permutation(n_r).astype(np.int32)
    sk = rk[rng.randint(0, n_r, size=n_s)].astype(np.int32)
    ones_r = np.ones(n_r, np.int32)
    ones_s = np.ones(n_s, np.int32)
    res = ClusteredJoin(small_cfg()).aggregate(as_rel(rk, ones_r), as_rel(sk, ones_s))
    assert res.aggregate == n_s  # PK-FK with payloads=1 -> |S|


def test_clustered_join_materialize(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=600, n_s=1800, dup_build=True)
    res = ClusteredJoin(small_cfg()).materialize(as_rel(rk, rp), as_rel(sk, sp),
                                                 capacity=200000)
    expect = oracle.join_materialize(rk, rp, sk, sp)
    assert res.count == expect.shape[0]
    out_r, out_s = res.pairs
    got = np.stack([np.asarray(out_r)[:res.count], np.asarray(out_s)[:res.count]], 1)
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    assert np.array_equal(got, expect)


def test_sort_merge_mode(rng):
    rk, rp, sk, sp = make_tables(rng, dup_build=True)
    cfg = small_cfg(probe_mode="sort_merge")
    res = ClusteredJoin(cfg).aggregate(as_rel(rk, rp), as_rel(sk, sp))
    assert res.aggregate == oracle.join_aggregate(rk, rp, sk, sp)


def test_streaming_join(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=2000, n_s=10000, dup_build=True)
    cfg = dataclasses.replace(small_cfg(), segment_rows=3000)
    res = streaming_join_aggregate(Relation(rk, rp), Relation(sk, sp), cfg)
    assert res.aggregate == oracle.join_aggregate(rk, rp, sk, sp)


def test_streaming_uses_staging_copy(rng, monkeypatch):
    """C17 wiring: segment assembly must go through datagen.staging_copy
    (the threaded AVX2 staging gather), and results stay exact."""
    from icde2019_gpu_join import datagen
    from icde2019_gpu_join.models import streaming as st

    calls = {"n": 0}
    real = datagen.staging_copy

    def counted(dst, src, num_threads=0):
        calls["n"] += 1
        real(dst, src, num_threads)

    monkeypatch.setattr(st.datagen, "staging_copy", counted)
    rk, rp, sk, sp = make_tables(rng, n_r=2000, n_s=10000, dup_build=True)
    cfg = dataclasses.replace(small_cfg(), segment_rows=3000)
    res = streaming_join_aggregate(Relation(rk, rp), Relation(sk, sp), cfg)
    assert res.aggregate == oracle.join_aggregate(rk, rp, sk, sp)
    assert calls["n"] == 2 * 4  # keys+payload per segment, 4 segments


def test_coprocess_join(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=5000, n_s=5000, dup_build=True)
    res = coprocess_join_aggregate(Relation(rk, rp), Relation(sk, sp), small_cfg())
    assert res.aggregate == oracle.join_aggregate(rk, rp, sk, sp)


def test_dispatcher_routes_by_size(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=1000, n_s=3000, dup_build=True)
    # tiny resident limit forces the streaming path
    cfg = dataclasses.replace(small_cfg(), resident_limit_rows=2000,
                              segment_rows=1000)
    res = clustered_probe_join(as_rel(rk, rp), Relation(sk, sp), cfg)
    assert res.aggregate == oracle.join_aggregate(rk, rp, sk, sp)
    # both small: in-memory path
    res2 = clustered_probe_join(as_rel(rk, rp), as_rel(sk, sp), small_cfg())
    assert res2.aggregate == res.aggregate


def test_late_aggregate(rng):
    n_r, n_s = 500, 1500
    rk = rng.permutation(2000)[:n_r].astype(np.int32)
    sk = rk[rng.randint(0, n_r, size=n_s)].astype(np.int32)
    r_cols = rng.randint(-50, 50, size=(n_r, 4)).astype(np.int32)
    s_cols = rng.randint(-50, 50, size=(n_s, 2)).astype(np.int32)
    r = Relation(jnp.asarray(rk))  # payload = row ids
    s = Relation(jnp.asarray(sk))
    res = ClusteredJoin(small_cfg()).late_aggregate(
        r, s, jnp.asarray(r_cols), jnp.asarray(s_cols))
    expect = oracle.join_late_materialize_sum(
        rk, np.arange(n_r, dtype=np.int32), sk, np.arange(n_s, dtype=np.int32),
        r_cols, s_cols)
    assert res.aggregate == expect


def test_placement_routes_to_streaming(rng):
    """probe_placement='host' must route through the streaming regime even
    when S fits in memory (the MEM_TYPE placement analog)."""
    import dataclasses
    from icde2019_gpu_join.config import EngineConfig
    from icde2019_gpu_join.models.joins import clustered_probe_join

    rk, rp, sk, sp = make_tables(rng)
    cfg = dataclasses.replace(EngineConfig(), probe_placement="host",
                              segment_rows=1024)
    res = clustered_probe_join(
        Relation(jnp.asarray(rk), jnp.asarray(rp)),
        Relation(np.asarray(sk), np.asarray(sp)), cfg)
    assert res.aggregate == oracle.join_aggregate(rk, rp, sk, sp)
    assert any(p.name == "stream" for p in res.timer.phases)


def test_placement_helpers():
    from icde2019_gpu_join.utils.placement import place, place_relation

    x = np.arange(256, dtype=np.int32)
    hbm = place(x, "hbm")
    assert np.array_equal(np.asarray(hbm), x)
    host = place(x, "host")
    assert isinstance(host, np.ndarray)
    pinned = place(x, "pinned_host")   # falls back gracefully on CPU
    assert np.array_equal(np.asarray(pinned), x)
    rel = place_relation(Relation(jnp.asarray(x)), "hbm")
    assert rel.num_rows == 256
