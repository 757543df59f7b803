"""On-card smoke test: the engine's main path, at real size, on NVIDIA GPUs.

    python chip_smoke.py            # one card: phases P0-P7
    python chip_smoke.py --multi    # four cards: the sharded exchange only

Run from a checkout. It refuses to run without a GPU. Every phase prints one
line: its name, the wall time of its first call (compile + run) and of a
warm repeat, the process's peak device memory so far, and ok/fail. Every
result is an integer with uint32-wraparound semantics, so every check is
bit-exact against an oracle that shares no code with the device path. Any
failure raises and the script exits non-zero. The last line of standard
output is one JSON object naming the device:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases (one card):
  P0 device      platform check; card name and power limit, JAX version,
                 XLA_FLAGS, compile-cache directory, data generator
  P1 compare     the four per-chunk compare/select helpers at [2048, 128] x
                 [2048, W*128], W in {1, 2}, vs numpy; the Triton chunk
                 kernel vs its plain version on a 2048-block chunk
  P2 config 1    1M x 16M PK-FK through clustered_probe_join
  P3 config 2    2^27 x 2^27 uniform and Zipf z=1.05 through
                 ClusteredJoin.aggregate, vs the checked-in oracle records
  P4 materialize 2^23 x 2^23 into a 2^24 ring (exact multiset), then
                 2^27 x 2^27 into the default 2^24 FOLD ring (total)
  P5 config 3    filter -> probe -> group-by, R 2^24, S 2^27, 64 groups
  P6 streaming   P3's uniform join with S streamed from host in 4 segments
  P7 exchange    distributed_join_segmented on a 1-card mesh, 2^24 per side
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Phase sizes; the defaults are the real ones."""

    compare_chunk: int = 2048
    config1: tuple = (1_000_000, 16_000_000)
    big_log2: int = 27                 # config 2, P4 FOLD leg, P6
    mat_log2: int = 23                 # P4 exact-multiset leg
    ring_log2: int = 24                # P4 capacity: the 2^24 FOLD ring
    fpg_r_log2: int = 24               # config 3
    fpg_s_log2: int = 27
    fpg_groups: int = 64
    stream_segments: int = 4
    exchange_log2: int = 24            # P7, per side
    multi_per_card_log2: int = 26      # --multi, per side per card
    multi_mat_per_card_log2: int = 22  # --multi materialize, per side per card


def last_line(devices) -> dict:
    """The result object printed as the last line of standard output."""
    d = devices[0]
    return {"ok": True, "device": {"platform": d.platform,
                                   "kind": d.device_kind,
                                   "count": len(devices)}}


def require_gpu(count: int):
    """P0's gate: the first `count` JAX devices, all GPUs, or exit non-zero
    before any phase runs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < count:
        sys.exit(f"chip_smoke: needs {count} GPU(s); JAX found "
                 f"{len(devices)} {devices[0].platform} device(s)")
    return devices[:count]


class Phases:
    """Runs phases in order and prints one line per phase."""

    def __init__(self, device):
        self.device = device

    def run(self, name: str, fn, reps: int = 2):
        """fn() runs the phase once and returns (ok, detail). It is called
        `reps` times: the first call compiles, the last is the warm one.
        Every call must be ok."""
        times, ok, detail = [], False, ""
        try:
            for _ in range(reps):
                t0 = time.perf_counter()
                ok, detail = fn()
                times.append(time.perf_counter() - t0)
                if not ok:
                    break
        finally:
            stats = self.device.memory_stats() or {}   # None on the CPU
            peak = stats.get("peak_bytes_in_use", 0)
            print(f"{name:<14} first_s={times[0] if times else float('nan'):.3f} "
                  f"warm_s={times[-1] if len(times) > 1 else float('nan'):.3f} "
                  f"peak_gib={peak / 2**30:.2f} "
                  f"{'ok' if ok and len(times) == reps else 'fail'} {detail}",
                  flush=True)
        if not ok:
            raise SystemExit(f"chip_smoke: phase {name} failed: {detail}")


# ---- numpy references for P1 (uint64 arithmetic reduced mod 2^32) --------

def _np_compare(sk, sp, rk, rp, gidx, step=128):
    """(sum, h, t, fm) of the four compare helpers' semantics, row-chunked."""
    total, hs, ts, fms = 0, [], [], []
    for i in range(0, sk.shape[0], step):
        eq = sk[i:i + step, :, None] == rk[i:i + step, None, :]
        rpu = rp[i:i + step, None, :].astype(np.uint32)
        t = np.where(eq, rpu, 0).sum(axis=2, dtype=np.uint64)
        total += int(np.sum(t * sp[i:i + step].astype(np.uint32),
                            dtype=np.uint64))
        hs.append(eq.sum(axis=2))
        ts.append((t % 2**32).astype(np.uint32).view(np.int32))
        fms.append(np.where(eq, gidx[i:i + step, None, :],
                            0x7FFFFFFF).min(axis=2))
    return total % 2**32, np.concatenate(hs), np.concatenate(ts), \
        np.concatenate(fms)


def _np_interval(pos, lo, hi, p, step=128):
    out = []
    for i in range(0, pos.shape[0], step):
        inb = (lo[i:i + step, None, :] <= pos[i:i + step, :, None]) & (
            pos[i:i + step, :, None] < hi[i:i + step, None, :])
        out.append(np.where(inb, p[i:i + step, None, :], 0).sum(axis=2))
    return np.concatenate(out)


def phase_compare(sz: Sizes):
    import jax
    import jax.numpy as jnp

    from icde2019_gpu_join.ops import band_join as bj
    from icde2019_gpu_join.ops.band_compare_triton import (
        chunk_compare_sum_triton)

    # the Triton kernel runs compiled on the card (interpreted only in the
    # CPU rehearsal of the tests)
    interpret = jax.default_backend() != "gpu"
    fns = {
        "sum": jax.jit(bj.banded_compare_sum),
        "per_s": jax.jit(bj.banded_compare_per_s),
        "first": jax.jit(bj.banded_compare_first),
        "interval": jax.jit(bj.banded_interval_select),
        "chunk": jax.jit(bj.chunk_compare_sum, static_argnums=8),
    }
    cases = []
    for w in (1, 2):
        r = np.random.RandomState(w)
        ch, wb = sz.compare_chunk, w * 128
        sk = r.randint(0, 300, (ch, 128)).astype(np.int32)
        sp = r.randint(-2**31, 2**31, (ch, 128), dtype=np.int64).astype(
            np.int32)
        rk = r.randint(0, 300, (ch, wb)).astype(np.int32)
        rp = r.randint(-2**31, 2**31, (ch, wb), dtype=np.int64).astype(
            np.int32)
        masked = r.rand(ch, wb) < 0.25          # rows outside any window
        rk[masked], rp[masked] = 0x7FFFFFFF, 0
        gidx = r.permutation(ch * wb).reshape(ch, wb).astype(np.int32)
        widths = r.randint(0, 5, (ch, wb)).astype(np.int32)
        lo = np.cumsum(widths, axis=1, dtype=np.int32) - widths
        hi = np.where(masked, lo, lo + widths)
        pos = r.randint(0, int(hi.max()) + 3, (ch, 128)).astype(np.int32)
        ref = _np_compare(sk, sp, rk, rp, gidx)
        ones = np.ones((ch, wb), np.int32)
        ref_sel = [_np_interval(pos, lo, hi, p) for p in (rp, gidx, ones)]
        dev = [jnp.asarray(a) for a in (sk, sp, rk, rp, gidx, pos, lo, hi)]
        # one real probe chunk for the Triton kernel vs its plain version
        nb = 2 * ch
        r_sv = np.sort(r.randint(0, 40 * nb, nb * 128)).astype(np.int32)
        chunk = [jnp.asarray(a) for a in (
            r.randint(0, 40 * nb, (nb, 128)).astype(np.int32),
            r.randint(-2**31, 2**31, (nb, 128), dtype=np.int64).astype(
                np.int32),
            r_sv.reshape(nb, 128),
            r.randint(-2**31, 2**31, (nb, 128), dtype=np.int64).astype(
                np.int32),
            r.randint(0, nb, ch).astype(np.int32),
            r.randint(-1, nb, ch).astype(np.int32))]
        chunk += [chunk[-1] + jnp.asarray(r.randint(0, 4, ch), jnp.int32),
                  jnp.asarray(r.rand(ch) < 0.9)]
        cases.append((w, dev, ref, ref_sel, chunk))

    def run():
        bad = []
        for w, (sk, sp, rk, rp, gidx, pos, lo, hi), ref, ref_sel, chunk \
                in cases:
            got_sum = int(fns["sum"](sk, sp, rk, rp))
            h, t = fns["per_s"](sk, rk, rp)
            h2, fm = fns["first"](sk, rk, gidx)
            sel = fns["interval"](pos, lo, hi, rp, gidx, jnp.ones_like(rp))
            checks = {
                "sum": got_sum == ref[0],
                "per_s": np.array_equal(np.asarray(h), ref[1])
                and np.array_equal(np.asarray(t), ref[2]),
                "first": np.array_equal(np.asarray(h2), ref[1])
                and np.array_equal(np.asarray(fm), ref[3]),
                "interval": all(np.array_equal(np.asarray(g), e)
                                for g, e in zip(sel, ref_sel)),
                "triton_chunk": int(chunk_compare_sum_triton(
                    *chunk, window_blocks=w, interpret=interpret))
                == int(fns["chunk"](*chunk, w)),
            }
            bad += [f"{k}[W={w}]" for k, v in checks.items() if not v]
        return not bad, "mismatch: " + ",".join(bad) if bad else \
            f"4 helpers x W in (1, 2) at [{sz.compare_chunk}, 128] exact; " \
            f"Triton chunk kernel == plain chunk at {sz.compare_chunk} blocks"

    return run


def _ones(n):
    return np.ones(n, np.int32)


def _pkfk(log2, skew=0.0):
    from icde2019_gpu_join.utils import datasets

    n = 1 << log2
    rk, sk = datasets.make_pk_fk(n, n, skew=skew, seed=12345)
    return rk, sk, datasets.pkfk_oracle_count(rk, sk, log2, skew)


def phase_config1(sz: Sizes):
    import jax.numpy as jnp

    from icde2019_gpu_join.models import clustered_probe_join
    from icde2019_gpu_join.relation import Relation
    from icde2019_gpu_join.utils import datasets, oracle

    n_r, n_s = sz.config1
    rk, sk = datasets.make_pk_fk(n_r, n_s, seed=12345)
    expect = oracle.join_count(rk, sk)
    r = Relation(jnp.asarray(rk), jnp.ones(n_r, jnp.int32))
    s = Relation(jnp.asarray(sk), jnp.ones(n_s, jnp.int32))

    def run():
        got = clustered_probe_join(r, s).aggregate
        return got == expect, f"{n_r}x{n_s} aggregate={got} oracle={expect}"

    return run


def phase_config2(rel, expect, tag):
    from icde2019_gpu_join.models import ClusteredJoin

    def run():
        got = ClusteredJoin().aggregate(*rel).aggregate
        return got == expect, f"{tag} aggregate={got} oracle={expect}"

    return run


def phase_materialize_exact(sz: Sizes):
    import jax.numpy as jnp

    from icde2019_gpu_join.models import ClusteredJoin
    from icde2019_gpu_join.relation import Relation
    from icde2019_gpu_join.utils import datasets, oracle

    n = 1 << sz.mat_log2
    cap = 1 << sz.ring_log2
    rk, sk = datasets.make_pk_fk(n, n, seed=12345)
    r = np.random.default_rng(3)
    rp = r.integers(-2**31, 2**31, n).astype(np.int32)
    sp = r.integers(-2**31, 2**31, n).astype(np.int32)
    expect = oracle.join_materialize(rk, rp, sk, sp)
    rel = (Relation(jnp.asarray(rk), jnp.asarray(rp)),
           Relation(jnp.asarray(sk), jnp.asarray(sp)))

    def run():
        res = ClusteredJoin().materialize(*rel, capacity=cap)
        out_r, out_s = map(np.asarray, res.pairs)
        t = res.count
        got = np.stack([out_r[:t], out_s[:t]], axis=1)
        got = got[np.lexsort((got[:, 1], got[:, 0]))]
        ok = (t == expect.shape[0] and not out_r[t:].any()
              and not out_s[t:].any() and np.array_equal(got, expect))
        return ok, f"2^{sz.mat_log2} into 2^{sz.ring_log2}: total={t} " \
                   f"oracle={expect.shape[0]} multiset " \
                   f"{'exact' if ok else 'MISMATCH'}"

    return run


def phase_materialize_fold(rel, expect, sz: Sizes):
    from icde2019_gpu_join.models import ClusteredJoin

    def run():
        res = ClusteredJoin().materialize(*rel, capacity=1 << sz.ring_log2)
        t = res.count
        return t == expect, f"2^{sz.big_log2} into the FOLD ring: " \
                            f"total={t} oracle={expect}"

    return run


def phase_config3(sz: Sizes):
    import jax.numpy as jnp

    from icde2019_gpu_join.models.pipelines import filter_probe_groupby
    from icde2019_gpu_join.utils import oracle

    n_r, n_s, groups = 1 << sz.fpg_r_log2, 1 << sz.fpg_s_log2, sz.fpg_groups
    r = np.random.default_rng(42)
    rk = r.permutation(n_r).astype(np.int32)
    rp = r.integers(1, 100, n_r).astype(np.int32)
    sk = rk[r.integers(0, n_r, n_s)].astype(np.int32)
    s_filter = r.integers(0, 1000, n_s).astype(np.int32)
    s_gid = r.integers(0, groups, n_s).astype(np.int32)
    ec, es = oracle.filter_probe_groupby(rk, rp, sk, s_filter, s_gid,
                                         100, 600, groups)
    args = [jnp.asarray(a) for a in (rk, rp, sk, s_filter, s_gid)]

    def run():
        cnt, sums = filter_probe_groupby(*args, jnp.int32(100),
                                         jnp.int32(600), num_groups=groups)
        ok = (np.array_equal(np.asarray(cnt), ec)
              and np.array_equal(np.asarray(sums), es))
        return ok, f"R 2^{sz.fpg_r_log2} S 2^{sz.fpg_s_log2} {groups} " \
                   f"groups: matches={int(ec.astype(np.int64).sum())} " \
                   f"{'exact' if ok else 'MISMATCH'}"

    return run


def phase_streaming(r_rel, sk, expect, sz: Sizes):
    from icde2019_gpu_join.config import EngineConfig
    from icde2019_gpu_join.models.streaming import streaming_join_aggregate
    from icde2019_gpu_join.relation import Relation

    s_host = Relation(sk, _ones(sk.size))     # stays in host numpy
    cfg = EngineConfig(segment_rows=sk.size // sz.stream_segments)

    def run():
        got = streaming_join_aggregate(r_rel, s_host, cfg).aggregate
        return got == expect, f"{sz.stream_segments} host segments: " \
                              f"aggregate={got} oracle={expect}"

    return run


def phase_exchange_1card(sz: Sizes):
    import jax.numpy as jnp

    from icde2019_gpu_join.parallel.dist_join import (
        distributed_join_segmented)
    from icde2019_gpu_join.parallel.mesh import make_mesh

    rk, sk, expect = _pkfk(sz.exchange_log2)
    n = rk.size
    args = (jnp.asarray(rk), jnp.ones(n, jnp.int32), jnp.asarray(sk),
            jnp.ones(n, jnp.int32))
    mesh = make_mesh(1)

    def run():
        agg, ov = distributed_join_segmented(*args, mesh=mesh,
                                             num_segments=4)
        agg, ov = int(agg), int(ov)
        return agg == expect and ov == 0, \
            f"1-card mesh 2^{sz.exchange_log2}/side: aggregate={agg} " \
            f"oracle={expect} overflow={ov}"

    return run


def run_single(sz: Sizes, devices):
    import jax.numpy as jnp

    from icde2019_gpu_join.relation import Relation

    ph = Phases(devices[0])
    ph.run("P1 compare", phase_compare(sz))
    ph.run("P2 config1", phase_config1(sz))

    rk, sk, expect_u = _pkfk(sz.big_log2)
    n = rk.size
    uni = (Relation(jnp.asarray(rk), jnp.ones(n, jnp.int32)),
           Relation(jnp.asarray(sk), jnp.ones(n, jnp.int32)))
    ph.run("P3 uniform", phase_config2(uni, expect_u, f"2^{sz.big_log2}"))
    zk, zs, expect_z = _pkfk(sz.big_log2, 1.05)
    zipf = (Relation(jnp.asarray(zk), jnp.ones(n, jnp.int32)),
            Relation(jnp.asarray(zs), jnp.ones(n, jnp.int32)))
    ph.run("P3 zipf1.05", phase_config2(zipf, expect_z,
                                        f"2^{sz.big_log2} z=1.05"))
    del zipf, zk, zs

    ph.run("P4 mat-exact", phase_materialize_exact(sz))
    ph.run("P4 mat-fold", phase_materialize_fold(uni, expect_u, sz))
    ph.run("P5 config3", phase_config3(sz))
    ph.run("P6 streaming", phase_streaming(uni[0], sk, expect_u, sz))
    del uni
    ph.run("P7 exchange", phase_exchange_1card(sz))


# ---- four cards ----------------------------------------------------------

def run_multi(sz: Sizes, devices):
    """The sharded exchange over a 1-D mesh of every card (NVLink is all to
    all, so no torus shape applies): aggregate, 50%-one-key heavy split
    with per-card executed loads, and materialization."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from icde2019_gpu_join import datagen
    from icde2019_gpu_join.parallel.dist_join import (
        distributed_join_materialize, distributed_join_segmented)
    from icde2019_gpu_join.parallel.mesh import make_mesh
    from icde2019_gpu_join.utils import datasets, oracle

    nd = len(devices)
    mesh = make_mesh(nd)
    sharded = NamedSharding(mesh, P("x"))

    def put(*arrays):
        out = [jax.device_put(a, sharded) for a in arrays]
        for a in out:
            if a.sharding.device_set != set(devices):
                raise SystemExit(f"chip_smoke: input on "
                                 f"{len(a.sharding.device_set)} of {nd} cards")
        return out

    def spans_all(a):
        return a.sharding.device_set == set(devices)

    ph = Phases(devices[0])
    log2 = sz.multi_per_card_log2 + (nd - 1).bit_length()
    rk, sk, expect = _pkfk(log2)
    n = rk.size
    args = put(rk, _ones(n), sk, _ones(n))

    def aggregate():
        agg, ov = distributed_join_segmented(*args, mesh=mesh)
        agg, ov = int(agg), int(ov)
        return agg == expect and ov == 0, \
            f"{nd} cards x 2^{sz.multi_per_card_log2}/side: " \
            f"aggregate={agg} oracle={expect} overflow={ov}"

    ph.run("M1 exchange", aggregate)

    rng = np.random.default_rng(9)
    sk_hot = np.where(rng.random(n) < 0.5, rk[0], sk).astype(np.int32)
    expect_hot = datagen.host_oracle_aggregate(rk, _ones(n), sk_hot, _ones(n))
    args_hot = put(rk, _ones(n), sk_hot, _ones(n))

    def heavy():
        agg, ov, loads = distributed_join_segmented(*args_hot, mesh=mesh,
                                                    return_loads=True)
        agg, ov = int(agg), int(ov)
        loads = np.asarray(loads)
        ok = (agg == expect_hot and ov == 0 and int(loads.sum()) == n
              and loads.max() <= 2.0 * n / nd)
        return ok, f"50%-one-key S: aggregate={agg} oracle={expect_hot} " \
                   f"overflow={ov} per-card loads={loads.tolist()} " \
                   f"spread={loads.max() * nd / n:.3f}x"

    ph.run("M2 heavy", heavy)

    m = (1 << sz.multi_mat_per_card_log2) * nd
    mk, msk = datasets.make_pk_fk(m, m, seed=12345)
    r = np.random.default_rng(4)
    mrp = r.integers(-2**31, 2**31, m).astype(np.int32)
    msp = r.integers(-2**31, 2**31, m).astype(np.int32)
    expect_pairs = oracle.join_materialize(mk, mrp, msk, msp)
    cap = -(-2 * expect_pairs.shape[0] // nd // 128) * 128
    margs = put(mk, mrp, msk, msp)

    def materialize():
        out_r, out_s, totals, ov = distributed_join_materialize(
            *margs, mesh=mesh, capacity_per_chip=cap)
        on_all = spans_all(out_r) and spans_all(out_s)
        out_r, out_s = np.asarray(out_r), np.asarray(out_s)
        totals = np.asarray(totals)
        got = np.concatenate([
            np.stack([out_r[d * cap:d * cap + t], out_s[d * cap:d * cap + t]],
                     axis=1) for d, t in enumerate(totals.tolist())])
        got = got[np.lexsort((got[:, 1], got[:, 0]))]
        ok = (int(ov) == 0 and on_all and np.array_equal(got, expect_pairs))
        return ok, f"{nd} cards x 2^{sz.multi_mat_per_card_log2}/side: " \
                   f"per-card totals={totals.tolist()} " \
                   f"rows={got.shape[0]} oracle={expect_pairs.shape[0]} " \
                   f"overflow={int(ov)} outputs on all cards={on_all} " \
                   f"multiset {'exact' if ok else 'MISMATCH'}"

    ph.run("M3 materialize", materialize)


def describe(devices):
    """P0's report: card, software, cache and data generator."""
    import jax

    from icde2019_gpu_join import datagen

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    for line in smi[:len(devices)]:
        print(line)
    print(f"jax {jax.__version__}; devices {len(devices)} x "
          f"{devices[0].device_kind}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    print("data generator: "
          + ("native C++" if datagen.native_lib() is not None
             else "numpy fallback"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded exchange")
    args = ap.parse_args(argv)
    count = 4 if args.multi else 1
    devices = require_gpu(count)
    t0 = time.perf_counter()
    describe(devices)
    print(f"P0 device      ok {devices[0].platform} x{count}", flush=True)
    (run_multi if args.multi else run_single)(Sizes(), devices)
    print(f"all phases ok in {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps(last_line(devices)))


if __name__ == "__main__":
    main()
