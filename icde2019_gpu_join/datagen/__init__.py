"""Dataset generator: ctypes bindings over the native C++ library, with a
numpy fallback that matches the same *distributions* (not bit-identical —
bit parity with reference .bin files requires the native path, which uses the
same glibc rand()/nrand48() primitives as reference src/generator_ETHZ.cu).

Also exposes the native host runtime: the OpenMP radix pre-partitioner,
staging copy, and knapsack batch scheduler (reference
src/partition-primitives.cu:40-469 analogs).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_SRC_PATH = os.path.join(_NATIVE_DIR, "host_engine.cpp")
_lib = None
_build_attempted = False


def _so_path() -> str:
    """The library's path, keyed on a hash of its source: a build is used
    only if it was made from the source as it stands (file mtimes do not
    survive every copy of a checkout, so they cannot decide staleness)."""
    with open(_SRC_PATH, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_NATIVE_DIR, f"libjoin_host-{digest}.so")


def _build_native(so_path: str) -> bool:
    global _build_attempted
    if _build_attempted:
        return os.path.exists(so_path)
    _build_attempted = True
    # build under a private name, then rename: concurrent importers (test
    # workers) never load a half-written library
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-fopenmp", "-mavx2",
        "-o", tmp, _SRC_PATH,
    ]
    for c in (cmd, [c for c in cmd if c != "-mavx2"]):  # non-x86: no AVX2
        try:
            subprocess.run(c, check=True, capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, so_path)
        return True
    return False


def native_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native host library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    so_path = _so_path()
    if not os.path.exists(so_path) and not _build_native(so_path):
        return None
    try:
        _lib = _bind(ctypes.CDLL(so_path))
    except (OSError, AttributeError):
        # a foreign or partial build: the documented None (callers fall
        # back to numpy)
        return None
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.tj_seed.argtypes = [ctypes.c_uint]
    lib.tj_random_gen.argtypes = [i32p, ctypes.c_uint64, ctypes.c_int64]
    lib.tj_random_unique_gen.argtypes = [i32p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_uint]
    lib.tj_fk_from_pk.argtypes = [i32p, ctypes.c_uint64, i32p, ctypes.c_uint64]
    lib.tj_gen_zipf.argtypes = [i32p, ctypes.c_uint64, ctypes.c_uint, ctypes.c_double]
    lib.tj_knuth_shuffle.argtypes = [i32p, ctypes.c_uint64]
    lib.tj_host_partition.argtypes = [
        i32p, i32p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, i32p, u64p, u64p,
    ]
    lib.tj_staging_copy.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.tj_knapsack_batches.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.tj_knapsack_batches.restype = ctypes.c_int
    lib.tj_oracle_join_aggregate.argtypes = [
        i32p, i32p, ctypes.c_uint64, i32p, i32p, ctypes.c_uint64,
    ]
    lib.tj_oracle_join_aggregate.restype = ctypes.c_int32
    return lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# --------------------------- generators -----------------------------------

def random_gen(n: int, maxid: int, seed: int = 12345) -> np.ndarray:
    """Uniform non-unique keys in [0, maxid) (reference random_gen,
    src/generator_ETHZ.cu:115-122)."""
    lib = native_lib()
    out = np.empty(n, dtype=np.int32)
    if lib is not None:
        lib.tj_seed(seed)
        lib.tj_random_gen(_i32p(out), n, maxid)
        return out
    rng = np.random.RandomState(seed)
    return rng.randint(0, maxid, size=n, dtype=np.int32)


def random_unique_gen(n: int, maxid: int, seed: int = 12345) -> np.ndarray:
    """Unique keys (a shuffled cycle of 0..maxid) (reference
    random_unique_gen, src/generator_ETHZ.cu:127-149)."""
    lib = native_lib()
    if lib is not None:
        out = np.empty(n, dtype=np.int32)
        lib.tj_random_unique_gen(_i32p(out), n, maxid, seed)
        return out
    base = np.empty(n, dtype=np.int32)
    fk = 0
    # vectorized fill of the wrap sequence 0,1..maxid,1,2..maxid,1,...
    if n <= maxid + 1:
        base = np.arange(n, dtype=np.int32)
    else:
        base[: maxid + 1] = np.arange(maxid + 1, dtype=np.int32)
        rest = np.arange(n - (maxid + 1), dtype=np.int64) % maxid + 1
        base[maxid + 1:] = rest.astype(np.int32)
    rng = np.random.RandomState(seed)
    return base[rng.permutation(n)]


def fk_from_pk(n_fk: int, pk: np.ndarray, seed: int = 12345) -> np.ndarray:
    """FK relation: tile the PK relation then shuffle (reference
    create_relation_fk_from_pk, src/generator_ETHZ.cu:162-187)."""
    lib = native_lib()
    pk = np.ascontiguousarray(pk, dtype=np.int32)
    if lib is not None:
        out = np.empty(n_fk, dtype=np.int32)
        lib.tj_seed(seed)
        lib.tj_fk_from_pk(_i32p(out), n_fk, _i32p(pk), pk.shape[0])
        return out
    reps = -(-n_fk // pk.shape[0])
    tiled = np.tile(pk, reps)[:n_fk]
    rng = np.random.RandomState(seed)
    return tiled[rng.permutation(n_fk)]


def gen_zipf(n: int, alphabet_size: int, z: float, seed: int = 12345) -> np.ndarray:
    """Zipf keys over a shuffled alphabet {1..alphabet_size} (reference
    gen_zipf/gen_zipf_lut/gen_alphabet, src/generator_ETHZ.cu:236-348)."""
    lib = native_lib()
    if lib is not None:
        out = np.empty(n, dtype=np.int32)
        lib.tj_seed(seed)
        lib.tj_gen_zipf(_i32p(out), n, alphabet_size, z)
        return out
    rng = np.random.RandomState(seed)
    alpha = rng.permutation(alphabet_size).astype(np.int32) + 1
    w = 1.0 / np.power(np.arange(1, alphabet_size + 1, dtype=np.float64), z)
    cdf = np.cumsum(w / w.sum())
    r = rng.random_sample(n)
    pos = np.searchsorted(cdf, r, side="left")
    return alpha[np.minimum(pos, alphabet_size - 1)]


# --------------------------- host runtime ----------------------------------

def host_partition(
    keys: np.ndarray, pays: np.ndarray, bits: int, first_bit: int = 0,
    num_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Native OpenMP radix pre-partition into CSR layout. Returns
    (keys', pays', counts, offsets). Falls back to numpy."""
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    pays = np.ascontiguousarray(pays, dtype=np.int32)
    parts = 1 << bits
    lib = native_lib()
    if lib is not None:
        ok = np.empty_like(keys)
        op = np.empty_like(pays)
        counts = np.empty(parts, dtype=np.uint64)
        offsets = np.empty(parts + 1, dtype=np.uint64)
        lib.tj_host_partition(
            _i32p(keys), _i32p(pays), keys.shape[0], bits, first_bit,
            num_threads, _i32p(ok), _i32p(op),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        )
        return ok, op, counts.astype(np.int64), offsets.astype(np.int64)
    from icde2019_gpu_join.utils import oracle

    k, p, c, o = oracle.radix_partition(keys, pays, bits, first_bit)
    return k, p, c, o


def oracle_join_aggregate(
    r_keys: np.ndarray, r_pay: np.ndarray,
    s_keys: np.ndarray, s_pay: np.ndarray,
) -> Optional[int]:
    """Native C++ oracle join aggregate SUM(Pr*Ps) mod 2^32 (the analog of
    the reference's never-called CPU oracle joinCpu,
    src/hash_join_clustered_probe.cu:2025-2059). Fully independent of the
    JAX/device path — used as the benchmark correctness gate. Returns None
    when the native library is unavailable (caller falls back to the numpy
    oracle)."""
    lib = native_lib()
    if lib is None:
        return None
    rk = np.ascontiguousarray(r_keys, dtype=np.int32)
    rp = np.ascontiguousarray(r_pay, dtype=np.int32)
    sk = np.ascontiguousarray(s_keys, dtype=np.int32)
    sp = np.ascontiguousarray(s_pay, dtype=np.int32)
    return int(lib.tj_oracle_join_aggregate(
        _i32p(rk), _i32p(rp), rk.shape[0], _i32p(sk), _i32p(sp),
        sk.shape[0]))


def host_oracle_aggregate(
    r_keys: np.ndarray, r_pay: np.ndarray,
    s_keys: np.ndarray, s_pay: np.ndarray,
) -> int:
    """The host oracle with fallback policy in ONE place: the native C++
    oracle when available, the (slow) numpy oracle otherwise. Every
    engine-independent correctness gate (bench.py, CLI -b 8, fuzz suites)
    goes through here."""
    got = oracle_join_aggregate(r_keys, r_pay, s_keys, s_pay)
    if got is None:
        from icde2019_gpu_join.utils import oracle
        got = int(oracle.join_aggregate(r_keys, r_pay, s_keys, s_pay))
    return got


def staging_copy(dst: np.ndarray, src: np.ndarray, num_threads: int = 0):
    """Threaded streaming copy into a (pinned) staging buffer."""
    lib = native_lib()
    if lib is not None and dst.nbytes == src.nbytes:
        lib.tj_staging_copy(
            dst.ctypes.data_as(ctypes.c_void_p),
            src.ctypes.data_as(ctypes.c_void_p),
            dst.nbytes, num_threads,
        )
    else:
        np.copyto(dst, src)


def knapsack_batches(gains: np.ndarray, capacity: int) -> np.ndarray:
    """Group items into batches by repeated 0/1 knapsack on gains.
    Returns batch index per item."""
    gains = np.ascontiguousarray(gains, dtype=np.float64)
    n = gains.shape[0]
    lib = native_lib()
    if lib is not None:
        out = np.empty(n, dtype=np.int32)
        lib.tj_knapsack_batches(
            gains.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
            capacity, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        return out
    # Greedy fallback: first-fit decreasing by gain.
    order = np.argsort(-gains)
    batch_of = np.full(n, -1, dtype=np.int32)
    batches: list = []
    weights = np.maximum(1, np.ceil(gains)).astype(np.int64)
    for i in order:
        placed = False
        for b, room in enumerate(batches):
            if room >= weights[i]:
                batches[b] -= weights[i]
                batch_of[i] = b
                placed = True
                break
        if not placed:
            batch_of[i] = len(batches)
            batches.append(capacity - min(weights[i], capacity))
    return batch_of
