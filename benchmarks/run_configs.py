"""Run the five BASELINE.json benchmark configs end to end.

Each config prints one JSON line: {config, metric, rows, seconds, mrows_s,
correct}. The default scales are cut below the nominal 1B/2B-row configs;
configs 4-6 exercise the exact code paths (coprocess / streaming /
distributed shuffle) at those scales; pass --full to attempt the nominal
sizes. One perf_counter per config, no trace: the benchmark with per-layer
device times is ROADMAP S1.

Usage: python benchmarks/run_configs.py [--configs 1,2,3,4,5[,6]] [--full]
(config 6 = 2B-shape streaming leg: S at 2^31 with --full, R capped at 512M)
"""

import argparse
import json
import sys
import os
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _report(config, metric, rows, seconds, correct, extra=None):
    out = {
        "config": config,
        "metric": metric,
        "rows": rows,
        "seconds": round(seconds, 4),
        "mrows_s": round(rows / seconds / 1e6, 2) if seconds else None,
        "correct": bool(correct),
    }
    if extra:
        out.update(extra)
    print(json.dumps(out), flush=True)


def _fingerprint(*arrays):
    """Content fingerprint of the gate's input datasets: sha256 over each
    array's size, full-content uint64 sum, and head/middle/tail row
    samples. Folded into the oracle cache key so a config's dataset
    recipe can never change without its cache key changing (round-4
    verdict: tag-only keys could silently gate the wrong value). The sum
    term touches every element (memory-bound, ~seconds at 2^31); the
    samples pin layout/order."""
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        a = np.asarray(a)
        h.update(np.int64(a.size).tobytes())
        h.update(np.uint64(a.astype(np.uint64, copy=False).sum()
                           if a.size else 0).tobytes())
        h.update(a[:4096].tobytes())
        h.update(a[a.size // 2: a.size // 2 + 4096].tobytes())
        h.update(a[-4096:].tobytes())
    return h.hexdigest()[:12]


def _cache_path(tag, fp):
    from icde2019_gpu_join import datagen
    gen = "native" if datagen.native_lib() is not None else "numpy"
    d = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"oracle_{tag}_g{gen}_{fp}.json")


def _oracle_agg_cached(tag, rk, sk):
    """Cached host-oracle SUM(1*1) (= match count mod 2^32) for the
    ones-payload configs, keyed by tag + dataset-content fingerprint. The
    expected value is computed once (C++ oracle, numpy fallback) and
    reused: at 2^30/2^31 the host oracle takes many minutes."""
    path = _cache_path(tag, _fingerprint(rk, sk))
    if os.path.exists(path):
        with open(path) as f:
            return int(json.load(f)["aggregate"])
    from icde2019_gpu_join import datagen
    agg = datagen.host_oracle_aggregate(
        rk, np.ones(rk.size, np.int32), sk, np.ones(sk.size, np.int32))
    with open(path, "w") as f:
        json.dump({"aggregate": int(agg), "n_r": int(rk.size),
                   "n_s": int(sk.size)}, f)
    return int(agg)


def _oracle_groupby_cached(tag, rk, rp, sk, s_filter, s_gid, lo, hi,
                           groups):
    """Cached numpy filter->probe->groupby oracle (config 3's gate),
    keyed by tag + content fingerprint of every input column."""
    from icde2019_gpu_join.utils import oracle
    path = _cache_path(tag, _fingerprint(rk, rp, sk, s_filter, s_gid))
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        return (np.asarray(rec["counts"], np.int64),
                np.asarray(rec["sums"], np.int64))
    ec, es = oracle.filter_probe_groupby(rk, rp, sk, s_filter, s_gid,
                                         lo, hi, groups)
    with open(path, "w") as f:
        json.dump({"counts": np.asarray(ec).tolist(),
                   "sums": np.asarray(es).tolist()}, f)
    return np.asarray(ec), np.asarray(es)


def _join_inputs(n_r, n_s, skew, seed=12345):
    import jax.numpy as jnp
    from icde2019_gpu_join.utils import datasets

    rk, sk = datasets.make_pk_fk(n_r, n_s, skew=skew, seed=seed)
    return rk, sk, jnp.asarray(rk), jnp.asarray(sk)


def config1():
    """1M x 16M uniform PK-FK, single pass."""
    import jax.numpy as jnp
    from icde2019_gpu_join.models import ClusteredJoin
    from icde2019_gpu_join.relation import Relation
    from icde2019_gpu_join.utils import oracle

    n_r, n_s = 1 << 20, 1 << 24
    rk, sk, rkd, skd = _join_inputs(n_r, n_s, 0.0)
    r = Relation(rkd, jnp.ones(n_r, jnp.int32))
    s = Relation(skd, jnp.ones(n_s, jnp.int32))
    eng = ClusteredJoin()
    res = eng.aggregate(r, s)  # warm-up/compile
    t0 = time.perf_counter()
    res = eng.aggregate(r, s)
    dt = time.perf_counter() - t0
    _report(1, "pkfk_1Mx16M", n_r + n_s, dt,
            res.aggregate == oracle.join_count(rk, sk))


def config2(scale):
    """128M x 128M uniform with payloads (headline; = bench.py)."""
    import jax.numpy as jnp
    from icde2019_gpu_join.models import ClusteredJoin
    from icde2019_gpu_join.ops.join_sorted import sort_merge_aggregate
    from icde2019_gpu_join.relation import Relation

    n = 1 << scale
    rk, sk, rkd, skd = _join_inputs(n, n, 0.0)
    rp = jnp.ones(n, jnp.int32)
    sp = jnp.ones(n, jnp.int32)
    r, s = Relation(rkd, rp), Relation(skd, sp)
    eng = ClusteredJoin()
    res = eng.aggregate(r, s)
    t0 = time.perf_counter()
    res = eng.aggregate(r, s)
    dt = time.perf_counter() - t0
    expect = int(sort_merge_aggregate(rkd, rp, skd, sp))
    _report(2, f"uniform_{n>>20}Mx{n>>20}M_payload", 2 * n, dt,
            res.aggregate == expect)

    # Materializing leg: the reference's Join1 measures BOTH probes —
    # materializing (join_partitioned_results into the 2^24-slot FOLD
    # ring, src/hash_join_clustered_probe.cu:913-916,937-940) and
    # count-only. Mirror it: same inputs, same 2^24 ring, wrap semantics.
    cap = 1 << 24
    resm = eng.materialize(r, s, capacity=cap)  # warm-up/compile
    t0 = time.perf_counter()
    resm = eng.materialize(r, s, capacity=cap)
    dt = time.perf_counter() - t0
    # correctness: total matches == aggregate mod 2^32 (payloads are 1).
    # Ring CONTENT exactness is covered by the multiset tests
    # (tests/test_band_join.py / test_distributed.py) and chip_smoke.py.
    ok = (resm.count % (1 << 32)) == (expect % (1 << 32))
    _report(2, f"materialize_{n>>20}Mx{n>>20}M_fold24", 2 * n, dt, ok,
            {"ring_slots": cap, "matches_mod32": int(resm.count)})


def config3(scale):
    """Filter -> probe -> group-by count/sum, fused (512M probe rows)."""
    import jax
    import jax.numpy as jnp
    from icde2019_gpu_join.models.pipelines import filter_probe_groupby
    from icde2019_gpu_join.utils import oracle

    n_r, n_s, groups = 1 << 24, 1 << scale, 64
    rng = np.random.default_rng(42)   # PCG64: ~20x faster than RandomState
    rk = rng.permutation(n_r).astype(np.int32)
    rp = rng.integers(1, 100, n_r).astype(np.int32)
    sk = rk[rng.integers(0, n_r, n_s)].astype(np.int32)
    s_filter = rng.integers(0, 1000, n_s).astype(np.int32)
    s_gid = rng.integers(0, groups, n_s).astype(np.int32)
    # above 2^27 probe rows the probe side streams in 2^27-row segments,
    # the reference's out-of-memory regime for this config (a size chosen
    # before this card; routing by free device memory is ROADMAP S7)
    segments = max(1, n_s >> 27)
    extra = {}
    args = (jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk),
            jnp.asarray(s_filter), jnp.asarray(s_gid))
    if segments > 1:
        from icde2019_gpu_join.models.pipelines import (
            filter_probe_groupby_streamed)
        run = lambda: filter_probe_groupby_streamed(
            *args, 100, 600, num_groups=groups, segments=segments)
        extra = {"segments": segments}
    else:
        run = lambda: filter_probe_groupby(
            *args, jnp.int32(100), jnp.int32(600), num_groups=groups)
    jax.block_until_ready(run())
    t0 = time.perf_counter()
    cnt, sums = run()
    cnt, sums = np.asarray(cnt), np.asarray(sums)
    dt = time.perf_counter() - t0
    ec, es = _oracle_groupby_cached(f"c3_s{scale}_seed42", rk, rp, sk,
                                    s_filter, s_gid, 100, 600, groups)
    ok = np.array_equal(cnt, ec) and np.array_equal(sums, es)
    _report(3, f"filter_probe_groupby_{n_s>>20}M", n_s, dt, ok, extra)


def config4(scale):
    """Zipf z=1.05 join with heavy-hitter handling (nominal 1B x 1B).

    At nominal scale the relations exceed HBM, so the size dispatcher
    routes through the co-processing regime (host 16-way pre-partition +
    per-pair device joins) — exactly the reference's Join2 shape. The
    oracle runs host-side (numpy sort + searchsorted over the full data)."""
    import numpy as np
    from icde2019_gpu_join.models.joins import clustered_probe_join
    from icde2019_gpu_join.relation import Relation
    from icde2019_gpu_join.utils import datasets

    n = 1 << scale
    rk, sk = datasets.make_pk_fk(n, n, skew=1.05, seed=12345)
    rp = np.ones(n, np.int32)
    sp = np.ones(n, np.int32)
    big = scale >= 28
    if big:
        r = Relation(rk, rp)
        s = Relation(sk, sp)
        t0 = time.perf_counter()
        res = clustered_probe_join(r, s)
        dt = time.perf_counter() - t0
    else:
        import jax.numpy as jnp
        from icde2019_gpu_join.models import ClusteredJoin
        r = Relation(jnp.asarray(rk), jnp.asarray(rp))
        s = Relation(jnp.asarray(sk), jnp.asarray(sp))
        eng = ClusteredJoin()
        res = eng.aggregate(r, s)
        t0 = time.perf_counter()
        res = eng.aggregate(r, s)
        dt = time.perf_counter() - t0
    expect = _oracle_agg_cached(
        f"c4_pkfk_s{scale}_z1.05_seed12345", rk, sk) & 0xFFFFFFFF
    got = int(np.uint32(np.int64(res.aggregate) & 0xFFFFFFFF))
    _report(4, f"zipf1.05_{n>>20}Mx{n>>20}M", 2 * n, dt, got == expect,
            {"regime": "coprocess" if big else "in_memory"})


def config5(scale):
    """Distributed join with the all-to-all shuffle: on one card the
    exchange path over a 1-device mesh, on several a mesh of all of them
    (the multi-card check with the oracle is `chip_smoke.py --multi`)."""
    import jax

    n_dev = len(jax.devices())
    if n_dev < 2:
        # the distributed exchange path on one card (1-device mesh:
        # partition_to_buckets + all_to_all + banded join all run; the
        # collective is degenerate but the code path is real)
        import jax.numpy as jnp
        from icde2019_gpu_join.parallel.dist_join import (
            distributed_join_aggregate, distributed_join_segmented)
        from icde2019_gpu_join.parallel.mesh import make_mesh
        from icde2019_gpu_join.ops.join_sorted import sort_merge_aggregate
        from icde2019_gpu_join.utils import datasets

        n1 = 1 << min(scale, 26)
        mesh = make_mesh(1)

        def leg(tag, rkd, rp, skd, sp, run):
            agg, ov = run()
            int(agg)   # sync warm-up (compile + first run) fully
            t0 = time.perf_counter()
            agg, ov = run()
            agg, ov = int(agg), int(ov)
            dt = time.perf_counter() - t0
            expect = int(sort_merge_aggregate(rkd, rp, skd, sp))
            _report(5, tag, rkd.shape[0] + skd.shape[0], dt,
                    agg == expect and ov == 0, {"overflow": ov})

        rk, sk, rkd, skd = _join_inputs(n1, n1, 0.0)
        rp = jnp.ones(n1, jnp.int32)
        sp = jnp.ones(n1, jnp.int32)
        # default pipeline: segmented exchange/probe, exact pre-pass caps
        leg(f"distributed_exchange_1chip_{n1>>20}Mx{n1>>20}M",
            rkd, rp, skd, sp,
            lambda: distributed_join_segmented(rkd, rp, skd, sp, mesh=mesh,
                                               num_segments=4))
        # one-shot (non-segmented) variant for comparison
        leg(f"distributed_oneshot_1chip_{n1>>20}Mx{n1>>20}M",
            rkd, rp, skd, sp,
            lambda: distributed_join_aggregate(rkd, rp, skd, sp, mesh=mesh))
        # Zipf z=1.05 exchange leg: skew inside the exchange (heavy keys
        # funnel to one destination; exact caps absorb it)
        rkz, skz = datasets.make_pk_fk(n1, n1, skew=1.05, seed=777)
        rkzd, skzd = jnp.asarray(rkz), jnp.asarray(skz)
        leg(f"distributed_zipf_1chip_{n1>>20}Mx{n1>>20}M",
            rkzd, rp, skzd, sp,
            lambda: distributed_join_segmented(rkzd, rp, skzd, sp,
                                               mesh=mesh, num_segments=4))
        return
    import jax.numpy as jnp
    from icde2019_gpu_join.parallel.dist_join import distributed_join_aggregate
    from icde2019_gpu_join.parallel.mesh import make_mesh
    from icde2019_gpu_join.ops.join_sorted import sort_merge_aggregate

    n = (1 << scale) // n_dev * n_dev
    rk, sk, rkd, skd = _join_inputs(n, n, 0.0)
    rp = jnp.ones(n, jnp.int32)
    sp = jnp.ones(n, jnp.int32)
    mesh = make_mesh(n_dev)
    agg, ov = distributed_join_aggregate(rkd, rp, skd, sp, mesh=mesh)
    t0 = time.perf_counter()
    agg, ov = distributed_join_aggregate(rkd, rp, skd, sp, mesh=mesh)
    dt = time.perf_counter() - t0
    expect = int(sort_merge_aggregate(rkd, rp, skd, sp))
    _report(5, f"distributed_{n>>20}Mx{n>>20}M_{n_dev}dev", 2 * n, dt,
            int(agg) == expect and int(ov) == 0)


def config6(scale_s):
    """2B-shape streaming join: R=512M device-resident, S=2^scale_s streamed
    through the staged double-buffered pipeline (the BASELINE headline is
    defined at 2B x 2B; 2B x 2B needs a pod slice — this is the largest
    single-card 2B-shape: the probe side at full 2B rows)."""
    import jax.numpy as jnp
    from icde2019_gpu_join.config import EngineConfig
    from icde2019_gpu_join.models.streaming import streaming_join_aggregate
    from icde2019_gpu_join.relation import Relation
    from icde2019_gpu_join.utils import datasets

    n_r, n_s = min(1 << 29, 1 << (scale_s - 2)), 1 << scale_s
    rk, sk = datasets.make_pk_fk(n_r, n_s, seed=12345)
    rp = np.ones(n_r, np.int32)
    sp = np.ones(n_s, np.int32)
    cfg = EngineConfig(segment_rows=min(1 << 27, n_s))
    t0 = time.perf_counter()
    res = streaming_join_aggregate(
        Relation(jnp.asarray(rk), jnp.asarray(rp)), Relation(sk, sp), cfg)
    dt = time.perf_counter() - t0
    expect = _oracle_agg_cached(
        f"c6_r{n_r}_s{n_s}_seed12345", rk, sk) & 0xFFFFFFFF
    got = int(np.uint32(np.int64(res.aggregate) & 0xFFFFFFFF))
    _report(6, f"streaming_{n_r>>20}Mx{n_s>>20}M", n_r + n_s, dt,
            got == expect,
            {"phases": {p.name: round(p.seconds, 2)
                        for p in res.timer.phases}})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--full", action="store_true",
                    help="nominal sizes (needs a pod slice / big HBM)")
    args = ap.parse_args()
    want = {int(c) for c in args.configs.split(",")}
    if 1 in want:
        config1()
    if 2 in want:
        config2(27)
    if 3 in want:
        config3(29 if args.full else 26)
    if 4 in want:
        config4(30 if args.full else 26)
    if 5 in want:
        config5(31 if args.full else 24)
    if 6 in want:
        config6(31 if args.full else 26)


if __name__ == "__main__":
    main()
