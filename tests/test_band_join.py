"""Banded sort-merge probe (ops/band_join.py) vs the numpy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from icde2019_gpu_join.ops.band_join import (
    banded_join_aggregate,
    banded_join_count,
    block_windows,
    sort_by_key,
)
from icde2019_gpu_join.utils import oracle
from tests.conftest import make_tables


def _agg(rk, rp, sk, sp, w=4):
    return int(banded_join_aggregate(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        window_blocks=w,
    ))


@pytest.mark.parametrize("w", [1, 2, 4])
def test_banded_aggregate_pkfk(rng, w):
    rk, rp, sk, sp = make_tables(rng)
    assert _agg(rk, rp, sk, sp, w) == oracle.join_aggregate(rk, rp, sk, sp)


def test_banded_aggregate_duplicates(rng):
    rk = rng.randint(0, 500, 4000).astype(np.int32)
    sk = rng.randint(0, 500, 6000).astype(np.int32)
    rp = rng.randint(-100, 100, rk.size).astype(np.int32)
    sp = rng.randint(-100, 100, sk.size).astype(np.int32)
    assert _agg(rk, rp, sk, sp) == oracle.join_aggregate(rk, rp, sk, sp)


def test_banded_aggregate_heavy_skew(rng):
    # one key holds ~half of S: windows widen -> multi-round path
    rk = rng.permutation(2000).astype(np.int32)
    sk = np.concatenate([
        np.full(5000, 7, np.int32),
        rng.randint(0, 2000, 5000).astype(np.int32),
    ])
    rng.shuffle(sk)
    rp = rng.randint(-10, 10, rk.size).astype(np.int32)
    sp = rng.randint(-10, 10, sk.size).astype(np.int32)
    assert _agg(rk, rp, sk, sp, w=2) == oracle.join_aggregate(rk, rp, sk, sp)


def test_banded_aggregate_no_matches(rng):
    rk = np.arange(1000, dtype=np.int32)
    sk = np.arange(5000, 9000, dtype=np.int32)
    rp = np.ones_like(rk)
    sp = np.ones_like(sk)
    assert _agg(rk, rp, sk, sp) == 0


def test_banded_aggregate_wraparound(rng):
    rk = np.zeros(100, np.int32)
    sk = np.zeros(100, np.int32)
    rp = np.full(100, 2**20, np.int32)
    sp = np.full(100, 2**20, np.int32)
    # 10^4 matches of 2^40 each: wraps int32
    assert _agg(rk, rp, sk, sp) == oracle.join_aggregate(rk, rp, sk, sp)


def test_banded_count(rng):
    rk, _, sk, _ = make_tables(rng, dup_build=True)
    got = int(banded_join_count(jnp.asarray(rk), jnp.asarray(sk)))
    assert got == oracle.join_count(rk, sk)


def test_block_windows_cover_all_matches(rng):
    rk = rng.randint(0, 300, 2000).astype(np.int32)
    sk = rng.randint(0, 300, 3000).astype(np.int32)
    r_sv, _ = sort_by_key(jnp.asarray(rk), jnp.zeros_like(jnp.asarray(rk)))
    s_sv, _ = sort_by_key(jnp.asarray(sk), jnp.zeros_like(jnp.asarray(sk)))
    lo, hi = block_windows(r_sv, s_sv)
    lo, hi = np.asarray(lo), np.asarray(hi)
    rs, ss = np.asarray(r_sv), np.asarray(s_sv)
    nrb = rs.size // 128
    for b in range(ss.size // 128):
        blk = ss[b * 128:(b + 1) * 128]
        for j in range(nrb):
            rblk = rs[j * 128:(j + 1) * 128]
            if np.intersect1d(blk, rblk).size:
                assert lo[b] <= j < hi[b], (b, j, lo[b], hi[b])


def test_banded_materialize(rng):
    from icde2019_gpu_join.ops.band_join import banded_materialize

    rk = rng.randint(0, 400, 2000).astype(np.int32)
    sk = rng.randint(0, 400, 3000).astype(np.int32)
    rp = rng.randint(1, 1000, rk.size).astype(np.int32)
    sp = rng.randint(1, 1000, sk.size).astype(np.int32)
    expect = oracle.join_materialize(rk, rp, sk, sp)
    cap = expect.shape[0] + 64
    out_r, out_s, total = banded_materialize(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        capacity=cap)
    assert int(total) == expect.shape[0]
    pairs = np.stack([np.asarray(out_r), np.asarray(out_s)], axis=1)
    pairs = pairs[(pairs[:, 0] != 0) | (pairs[:, 1] != 0)]
    got = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    assert np.array_equal(got, expect)


def test_banded_materialize_sparse_wide_fm_guard(rng):
    """Regression (round-2 advisor, high): the fast-path R-span check used
    blockmax_fmh[s_nxt_blk] alone — vacuously 0 when the clipped anchor
    block holds no matched rows — while a wide-fm match inside the anchor
    block itself escaped the span check and was silently dropped by
    _extract_blocked's static R window. Scenario: unique-key R, a selective
    S whose last matched row has fm far beyond the window, plus trailing
    unmatched rows so s_nxt_blk clips to an all-unmatched block."""
    from icde2019_gpu_join.ops.band_join import banded_materialize

    rk = np.arange(20000, dtype=np.int32)
    rp = (rk + 1).astype(np.int32)
    # two matches: fm=0 and fm=19999; then ~300 trailing non-matching keys
    # that sort after all R keys
    sk = np.concatenate([np.asarray([0, 19999], np.int32),
                         np.arange(30000, 30300, dtype=np.int32)])
    sp = np.full(sk.size, 7, np.int32)
    expect = oracle.join_materialize(rk, rp, sk, sp)
    assert expect.shape[0] == 2
    out_r, out_s, total = banded_materialize(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        capacity=128)
    assert int(total) == 2
    pairs = np.stack([np.asarray(out_r), np.asarray(out_s)], axis=1)
    pairs = pairs[(pairs[:, 0] != 0) | (pairs[:, 1] != 0)]
    got = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    assert np.array_equal(got, expect), (
        "wide-fm matched row dropped by materialize fast path")


def test_banded_match_descriptors(rng):
    from icde2019_gpu_join.ops.band_join import (
        banded_match_descriptors, sort_by_key)

    rk = rng.randint(0, 100, 600).astype(np.int32)
    sk = rng.randint(0, 100, 900).astype(np.int32)
    r_sv, _ = sort_by_key(jnp.asarray(rk), jnp.zeros(600, jnp.int32))
    s_sv, _ = sort_by_key(jnp.asarray(sk), jnp.zeros(900, jnp.int32))
    h, fm = banded_match_descriptors(r_sv, s_sv)
    h, fm = np.asarray(h)[:900], np.asarray(fm)[:900]
    rs = np.asarray(r_sv).astype(np.int64)
    ss = np.asarray(s_sv).astype(np.int64)
    for i in range(900):
        hits = np.nonzero(rs == ss[i])[0]
        assert h[i] == hits.size
        if hits.size:
            assert fm[i] == hits[0]


@pytest.mark.parametrize("n_r,n_s", [(0, 5), (5, 0), (0, 0), (1, 1), (127, 129)])
def test_banded_edge_shapes(n_r, n_s):
    rk = jnp.asarray(np.arange(n_r, dtype=np.int32))
    sk = jnp.asarray(np.zeros(n_s, dtype=np.int32))
    v = int(banded_join_aggregate(rk, jnp.ones(n_r, jnp.int32),
                                  sk, jnp.ones(n_s, jnp.int32)))
    assert v == (n_s if n_r > 0 and n_s > 0 else 0)


def test_banded_fuzz_vs_oracle(rng):
    """Randomized shapes/distributions vs the oracle (CPU)."""
    for _ in range(12):
        n_r = int(rng.randint(1, 3000))
        n_s = int(rng.randint(1, 5000))
        kmax = int(rng.choice([10, 300, 1 << 16, 1 << 30]))
        rk = rng.randint(0, kmax, n_r).astype(np.int32)
        sk = rng.randint(0, kmax, n_s).astype(np.int32)
        rp = rng.randint(-1000, 1000, n_r).astype(np.int32)
        sp = rng.randint(-1000, 1000, n_s).astype(np.int32)
        w = int(rng.choice([1, 2, 4]))
        got = _agg(rk, rp, sk, sp, w)
        assert got == oracle.join_aggregate(rk, rp, sk, sp), (n_r, n_s, kmax, w)


def test_banded_materialize_wrap_ring(rng):
    """FOLD-ring semantics: capacity < total matches, match m lands in slot
    m mod capacity with later matches overwriting earlier (the engine's
    match order is S-sorted; the reference ring is
    src/join-primitives.cu:1371-1373)."""
    from icde2019_gpu_join.ops.band_join import (
        banded_match_descriptors, banded_materialize, sort_by_key)

    rk = rng.randint(0, 50, 700).astype(np.int32)
    sk = rng.randint(0, 50, 1100).astype(np.int32)
    rp = rng.randint(1, 1000, rk.size).astype(np.int32)
    sp = rng.randint(1, 1000, sk.size).astype(np.int32)

    # oracle expansion in the engine's S-sorted match order
    r_sv, r_p = sort_by_key(jnp.asarray(rk), jnp.asarray(rp))
    s_sv, s_p = sort_by_key(jnp.asarray(sk), jnp.asarray(sp))
    h, fm = banded_match_descriptors(r_sv, s_sv)
    h = np.asarray(h)[:sk.size]
    fm = np.asarray(fm)[:sk.size]
    rpn, spn = np.asarray(r_p), np.asarray(s_p)[:sk.size]
    stream_r, stream_s = [], []
    for i in range(sk.size):
        for k in range(h[i]):
            stream_r.append(rpn[fm[i] + k])
            stream_s.append(spn[i])
    total = len(stream_r)
    cap = total // 3 + 1   # forces >2 laps around the ring
    assert cap < total
    exp_r, exp_s = np.zeros(cap, np.int32), np.zeros(cap, np.int32)
    for m in range(total):
        exp_r[m % cap] = stream_r[m]
        exp_s[m % cap] = stream_s[m]

    out_r, out_s, tot = banded_materialize(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        capacity=cap, wrap=True)
    assert int(tot) == total
    np.testing.assert_array_equal(np.asarray(out_r), exp_r)
    np.testing.assert_array_equal(np.asarray(out_s), exp_s)


def test_materialize_fast_path_engaged_and_exact(rng):
    """The block-windowed fast path must engage on matched-dense inputs and
    agree with the oracle; sparse/filtered inputs fall back, also exact."""
    from icde2019_gpu_join.ops.band_join import banded_materialize

    cases = [
        # dense PK-FK-ish: fast path territory
        (rng.permutation(4000).astype(np.int32),
         rng.randint(0, 4000, 6000).astype(np.int32)),
        # only ~1/50 of S matches: owner spans blow up -> fallback
        (rng.permutation(100).astype(np.int32),
         rng.randint(0, 5000, 6000).astype(np.int32)),
        # heavy duplicates both sides
        (rng.randint(0, 30, 2000).astype(np.int32),
         rng.randint(0, 30, 1000).astype(np.int32)),
    ]
    for rk, sk in cases:
        rp = rng.randint(1, 1000, rk.size).astype(np.int32)
        sp = rng.randint(1, 1000, sk.size).astype(np.int32)
        expect = oracle.join_materialize(rk, rp, sk, sp)
        cap = expect.shape[0] + 200
        out_r, out_s, total = banded_materialize(
            jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk),
            jnp.asarray(sp), capacity=cap)
        assert int(total) == expect.shape[0]
        pairs = np.stack([np.asarray(out_r), np.asarray(out_s)], axis=1)
        pairs = pairs[(pairs[:, 0] != 0) | (pairs[:, 1] != 0)]
        got = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
        exp = expect[(expect[:, 0] != 0) | (expect[:, 1] != 0)]
        np.testing.assert_array_equal(got, exp)


def test_materialize_fast_path_forced(rng):
    """Force the block-windowed path alone on a dense case: exactness here
    (not just via the cond) proves the fast branch itself."""
    from icde2019_gpu_join.ops.band_join import banded_materialize

    rk = rng.permutation(4000).astype(np.int32)
    sk = rng.randint(0, 4000, 6000).astype(np.int32)
    rp = rng.randint(1, 1000, rk.size).astype(np.int32)
    sp = rng.randint(1, 1000, sk.size).astype(np.int32)
    expect = oracle.join_materialize(rk, rp, sk, sp)
    cap = expect.shape[0] + 200
    out_r, out_s, total = banded_materialize(
        jnp.asarray(rk), jnp.asarray(rp), jnp.asarray(sk), jnp.asarray(sp),
        capacity=cap, debug_force="fast")
    assert int(total) == expect.shape[0]
    pairs = np.stack([np.asarray(out_r), np.asarray(out_s)], axis=1)
    pairs = pairs[(pairs[:, 0] != 0) | (pairs[:, 1] != 0)]
    got = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    exp = expect[(expect[:, 0] != 0) | (expect[:, 1] != 0)]
    np.testing.assert_array_equal(got, exp)


# ---- the four per-chunk compare/select helpers at the engine's real chunk
# width ([2048, 128] S tiles against [2048, W*128] windows), each against a
# numpy uint64 reference reduced mod 2^32; masked window rows included.

_CH = 2048
_R_PAD = 0x7FFFFFFF


def _compare_inputs(w, seed):
    r = np.random.RandomState(seed)
    wb = w * 128
    sk = r.randint(0, 300, (_CH, 128)).astype(np.int32)
    sp = r.randint(-2**31, 2**31, (_CH, 128), dtype=np.int64).astype(np.int32)
    rk = r.randint(0, 300, (_CH, wb)).astype(np.int32)
    rp = r.randint(-2**31, 2**31, (_CH, wb), dtype=np.int64).astype(np.int32)
    masked = r.rand(_CH, wb) < 0.25       # rows outside any window
    rk[masked] = _R_PAD
    rp[masked] = 0
    return sk, sp, rk, rp


def _row_chunks(*arrs, step=128):
    for i in range(0, _CH, step):
        yield tuple(a[i:i + step] for a in arrs)


@pytest.mark.parametrize("w", [1, 2])
def test_compare_sum_matches_numpy(w):
    from icde2019_gpu_join.ops.band_join import banded_compare_sum

    sk, sp, rk, rp = _compare_inputs(w, 10 + w)
    got = int(banded_compare_sum(*map(jnp.asarray, (sk, sp, rk, rp))))
    expect = 0
    for skc, spc, rkc, rpc in _row_chunks(sk, sp, rk, rp):
        eq = skc[:, :, None] == rkc[:, None, :]
        per_s = np.where(eq, rpc[:, None, :].astype(np.uint32), 0).sum(
            axis=2, dtype=np.uint64)
        expect += int(np.sum(per_s * spc.astype(np.uint32), dtype=np.uint64))
    assert got == expect % 2**32


@pytest.mark.parametrize("w", [1, 2])
def test_compare_per_s_matches_numpy(w):
    from icde2019_gpu_join.ops.band_join import banded_compare_per_s

    sk, _, rk, rp = _compare_inputs(w, 20 + w)
    h, t = banded_compare_per_s(*map(jnp.asarray, (sk, rk, rp)))
    eh, et = [], []
    for skc, rkc, rpc in _row_chunks(sk, rk, rp):
        eq = skc[:, :, None] == rkc[:, None, :]
        eh.append(eq.sum(axis=2))
        et.append(np.where(eq, rpc[:, None, :].astype(np.int64), 0).sum(axis=2))
    np.testing.assert_array_equal(np.asarray(h), np.concatenate(eh))
    np.testing.assert_array_equal(
        np.asarray(t), (np.concatenate(et) % 2**32).astype(np.uint32).view(
            np.int32))


@pytest.mark.parametrize("w", [1, 2])
def test_compare_first_matches_numpy(w):
    from icde2019_gpu_join.ops.band_join import banded_compare_first

    sk, _, rk, _ = _compare_inputs(w, 30 + w)
    gidx = np.random.RandomState(w).permutation(rk.size).reshape(
        rk.shape).astype(np.int32)
    h, fm = banded_compare_first(*map(jnp.asarray, (sk, rk, gidx)))
    eh, ef = [], []
    for skc, rkc, gxc in _row_chunks(sk, rk, gidx):
        eq = skc[:, :, None] == rkc[:, None, :]
        eh.append(eq.sum(axis=2))
        ef.append(np.where(eq, gxc[:, None, :], _R_PAD).min(axis=2))
    np.testing.assert_array_equal(np.asarray(h), np.concatenate(eh))
    np.testing.assert_array_equal(np.asarray(fm), np.concatenate(ef))


@pytest.mark.parametrize("w", [1, 2])
def test_interval_select_matches_numpy(w):
    from icde2019_gpu_join.ops.band_join import banded_interval_select

    r = np.random.RandomState(40 + w)
    wb = w * 128
    widths = r.randint(0, 5, (_CH, wb)).astype(np.int32)
    lo = np.cumsum(widths, axis=1, dtype=np.int32) - widths
    hi = lo + widths
    hi[r.rand(_CH, wb) < 0.25] = lo[0, 0] - 1   # masked: empty interval
    p1 = r.randint(-2**31, 2**31, (_CH, wb), dtype=np.int64).astype(np.int32)
    p2 = r.randint(-1000, 1000, (_CH, wb)).astype(np.int32)
    p3 = np.ones((_CH, wb), np.int32)
    pos = r.randint(0, int(hi.max()) + 3, (_CH, 128)).astype(np.int32)
    outs = banded_interval_select(*map(jnp.asarray, (pos, lo, hi, p1, p2, p3)))
    for got, p in zip(outs, (p1, p2, p3)):
        exp = []
        for pc, lc, hc, ppc in _row_chunks(pos, lo, hi, p):
            inb = (lc[:, None, :] <= pc[:, :, None]) & (
                pc[:, :, None] < hc[:, None, :])
            assert inb.sum(axis=2).max() <= 1       # disjoint intervals
            exp.append(np.where(inb, ppc[:, None, :], 0).sum(axis=2))
        np.testing.assert_array_equal(np.asarray(got), np.concatenate(exp))
