"""Direct unit tests for the native host runtime (host_engine.cpp):
tj_host_partition (incl. the AVX2 write-combining scatter) and
tj_knapsack_batches — previously covered only transitively through
coprocess_join_aggregate."""

import numpy as np
import pytest

from icde2019_gpu_join import datagen
from icde2019_gpu_join.utils import oracle


@pytest.fixture(scope="module")
def lib():
    if datagen.native_lib() is None:
        pytest.skip("native lib unavailable")
    return datagen


@pytest.mark.parametrize("bits,first_bit,n", [
    (4, 0, 100_000),     # WC path (parts=16)
    (8, 0, 300_000),     # WC path boundary (parts=256)
    (10, 3, 200_000),    # plain scatter path (parts=1024)
    (4, 0, 63),          # tiny: partial WC buffers only
    (4, 28, 10_000),     # high radix field
])
def test_host_partition_matches_oracle(lib, bits, first_bit, n):
    rng = np.random.RandomState(bits * 100 + first_bit)
    keys = rng.randint(-(1 << 31), 1 << 31, n).astype(np.int32)
    pays = rng.randint(-1000, 1000, n).astype(np.int32)
    ok, op, counts, offsets = lib.host_partition(keys, pays, bits, first_bit)
    ek, ep, ec, eo = oracle.radix_partition(keys, pays, bits, first_bit)
    np.testing.assert_array_equal(counts, ec)
    np.testing.assert_array_equal(offsets, eo)
    # CSR region contents must be a permutation of the oracle region with
    # identical (key, pay) multisets (thread interleaving reorders rows
    # within a partition).
    for p in range(1 << bits):
        lo, hi = int(offsets[p]), int(offsets[p + 1])
        got = np.stack([ok[lo:hi], op[lo:hi]], 1)
        exp = np.stack([ek[lo:hi], ep[lo:hi]], 1)
        got = got[np.lexsort((got[:, 1], got[:, 0]))]
        exp = exp[np.lexsort((exp[:, 1], exp[:, 0]))]
        np.testing.assert_array_equal(got, exp)


def test_host_partition_single_thread_stable(lib):
    """With one thread the scatter is stable: rows of a partition keep
    input order (WC buffers flush in append order)."""
    rng = np.random.RandomState(0)
    n = 50_000
    keys = rng.randint(0, 1 << 20, n).astype(np.int32)
    pays = np.arange(n, dtype=np.int32)
    ok, op, counts, offsets = lib.host_partition(keys, pays, 4, 0,
                                                 num_threads=1)
    pid = keys & 15
    order = np.argsort(pid, kind="stable")   # stable partition permutation
    np.testing.assert_array_equal(ok, keys[order])
    np.testing.assert_array_equal(op, pays[order])


def test_knapsack_batches_capacity_respected(lib):
    rng = np.random.RandomState(1)
    gains = rng.uniform(0.1, 3.0, 40)
    cap = 5
    batch_of = lib.knapsack_batches(gains, cap)
    assert batch_of.min() >= 0
    weights = np.maximum(1, np.ceil(gains)).astype(np.int64)
    for b in range(batch_of.max() + 1):
        members = np.nonzero(batch_of == b)[0]
        assert members.size > 0, f"empty batch {b}"
        # every batch fits the resident capacity exactly (single items whose
        # weight exceeds capacity get clamped and fill a batch alone — the
        # only case a batch's TRUE weight may exceed cap, carved out by the
        # size>1 guard)
        if members.size > 1:
            assert weights[members].sum() <= cap


def test_knapsack_single_oversized_item(lib):
    batch_of = lib.knapsack_batches(np.array([10.0, 0.5, 0.5]), 2)
    assert batch_of.min() >= 0
    # the two small items don't share a batch with the oversized one
    assert batch_of[1] == batch_of[2] != batch_of[0]


def test_host_partition_bandwidth_report(lib):
    """Measure and print the CPU partition bandwidth (the reference prints
    this at src/partition-primitives.cu:218). Not a perf assert — just a
    recorded signal."""
    import time
    rng = np.random.RandomState(2)
    n = 4_000_000
    keys = rng.randint(0, 1 << 30, n).astype(np.int32)
    pays = np.arange(n, dtype=np.int32)
    lib.host_partition(keys, pays, 4, 0)  # warm
    t0 = time.perf_counter()
    lib.host_partition(keys, pays, 4, 0)
    dt = time.perf_counter() - t0
    mbps = 16 * n / dt / 1e6
    print(f"\nhost_partition: {mbps:.0f} MB/s ({n/dt/1e6:.0f} Mrows/s)")
    assert mbps > 100  # sanity floor only


@pytest.mark.parametrize("n_r,n_s,dom", [
    (5000, 8000, 300),     # many duplicate keys both sides
    (4096, 4096, 10**6),   # sparse domain, few matches
    (1, 1, 1),             # degenerate
    (3000, 1, 100),
])
def test_native_oracle_join_aggregate_matches_numpy(lib, n_r, n_s, dom):
    rng = np.random.RandomState(n_r + n_s)
    rk = rng.randint(-dom, dom, n_r).astype(np.int32)
    sk = rng.randint(-dom, dom, n_s).astype(np.int32)
    # full-range payloads: exercises the mod-2^32 wraparound semantics
    rp = rng.randint(-(1 << 31), 1 << 31, n_r).astype(np.int32)
    sp = rng.randint(-(1 << 31), 1 << 31, n_s).astype(np.int32)
    got = lib.oracle_join_aggregate(rk, rp, sk, sp)
    want = oracle.join_aggregate(rk, rp, sk, sp)
    assert got == want


def test_native_oracle_join_aggregate_empty(lib):
    e = np.empty(0, np.int32)
    k = np.arange(10, dtype=np.int32)
    assert lib.oracle_join_aggregate(e, e, k, k) == 0
    assert lib.oracle_join_aggregate(k, k, e, e) == 0
