"""sort_impl threading: per-engine static argument, not a process global.

`set_sort_impl` once flipped a module global and `jax.clear_caches()`; two
engines with different `EngineConfig.sort_impl` in one process silently
fought (the last-constructed engine's impl won for BOTH). Now the impl is
resolved per call and threaded as a jit static argument, so each impl owns
its own compile-cache entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icde2019_gpu_join.config import EngineConfig
from icde2019_gpu_join.models import ClusteredJoin
from icde2019_gpu_join.relation import Relation

import icde2019_gpu_join.ops.band_join as bj
from icde2019_gpu_join.ops.sort import packed_sort_pairs


def _data(rng, n_r=1664, n_s=3328):
    """Unique-ish shapes so each impl provably re-traces in this test."""
    rk = rng.permutation(n_r).astype(np.int32)
    rp = rng.integers(1, 100, n_r).astype(np.int32)
    sk = rng.integers(0, n_r, n_s).astype(np.int32)
    sp = rng.integers(1, 100, n_s).astype(np.int32)
    table = np.zeros(n_r, np.int64)
    table[rk] = rp
    expect = np.int32(np.sum(table[sk] * sp.astype(np.int64)) & 0xFFFFFFFF)
    return rk, rp, sk, sp, int(expect)


def test_engines_with_different_sort_impls_coexist(monkeypatch):
    rng = np.random.default_rng(7)
    rk, rp, sk, sp, expect = _data(rng)
    r = Relation(rk, rp)
    s = Relation(sk, sp)

    packed_traces = []
    orig_packed = bj.packed_sort_pairs

    def counting_packed(sv, pv):
        packed_traces.append(1)
        return orig_packed(sv, pv)

    monkeypatch.setattr(bj, "packed_sort_pairs", counting_packed)

    default_before = bj.get_sort_impl()
    e_lax = ClusteredJoin(EngineConfig(sort_impl="lax"))
    e_packed = ClusteredJoin(EngineConfig(sort_impl="packed"))
    # constructing an engine must NOT touch the process default anymore
    assert bj.get_sort_impl() == default_before

    a1 = e_lax.aggregate(r, s).aggregate
    assert len(packed_traces) == 0          # lax engine never hits packed
    a2 = e_packed.aggregate(r, s).aggregate
    assert len(packed_traces) > 0           # packed engine traces packed
    n_after_packed = len(packed_traces)
    a3 = e_lax.aggregate(r, s).aggregate    # interleaved: still lax
    assert len(packed_traces) == n_after_packed
    assert a1 == a2 == a3 == expect


def test_set_sort_impl_is_default_only(monkeypatch):
    """Flipping the process default must not invalidate other impls'
    compiled entries (no clear_caches) and per-call overrides win."""
    rng = np.random.default_rng(11)
    rk, rp, sk, sp, expect = _data(rng, n_r=1408, n_s=2816)

    before = bj.get_sort_impl()
    try:
        bj.set_sort_impl("packed")
        # explicit per-call override beats the default
        agg = bj.banded_join_aggregate(rk, rp, sk, sp, sort_impl="lax")
        assert int(agg) == expect
        # default applies when no override given
        agg2 = bj.banded_join_aggregate(rk, rp, sk, sp)
        assert int(agg2) == expect
    finally:
        bj.set_sort_impl(before)


def test_resolve_sort_impl_validates():
    with pytest.raises(ValueError, match="bogus"):
        bj.resolve_sort_impl("bogus")
    assert bj.resolve_sort_impl(None) == bj.get_sort_impl()


@pytest.mark.parametrize("field,value", [("probe_mode", "pallas"),
                                         ("sort_impl", "merge")])
def test_removed_modes_rejected(field, value):
    """Removed kernel paths fail loudly at configuration time."""
    with pytest.raises(ValueError, match=f"unknown {field} '{value}'"):
        EngineConfig(**{field: value})


_I32_MIN, _I32_MAX = -2**31, 2**31 - 1


def _packed_case(name):
    r = np.random.default_rng(5)
    if name == "extremes":
        sv = np.array([_I32_MAX, _I32_MIN, 0, -1, 1, _I32_MAX, _I32_MIN] * 40,
                      np.int32)
        pv = r.integers(_I32_MIN, _I32_MAX, sv.size, endpoint=True).astype(
            np.int32)
        pv[:4] = [_I32_MIN, _I32_MAX, -1, 0]
    elif name == "duplicates":
        sv = r.integers(-3, 3, 4096).astype(np.int32)
        pv = r.integers(-50, 50, sv.size).astype(np.int32)
    elif name == "non_pow2":
        sv = r.integers(_I32_MIN, _I32_MAX, 3001, endpoint=True).astype(
            np.int32)
        pv = r.integers(_I32_MIN, _I32_MAX, sv.size, endpoint=True).astype(
            np.int32)
    else:   # "single"
        sv = np.array([7], np.int32)
        pv = np.array([_I32_MIN], np.int32)
    return sv, pv


@pytest.mark.parametrize("case", ["extremes", "duplicates", "non_pow2",
                                  "single"])
def test_packed_sort_pairs_matches_lax_sort(case):
    """Same key order as the 2-operand lax.sort and the same per-key payload
    multiset (payload order within a key is unspecified)."""
    sv, pv = _packed_case(case)
    ko, vo = map(np.asarray, packed_sort_pairs(jnp.asarray(sv),
                                                jnp.asarray(pv)))
    ks, vs = map(np.asarray, jax.lax.sort(
        (jnp.asarray(sv), jnp.asarray(pv)), num_keys=1, is_stable=False))
    np.testing.assert_array_equal(ko, ks)
    got = sorted(zip(ko.tolist(), vo.tolist()))
    assert got == sorted(zip(ks.tolist(), vs.tolist()))
    assert ko.dtype == vo.dtype == np.int32
