"""Dataset creation + the reference's .bin file cache.

Reproduces the reference's reproducibility mechanism: generated relations are
cached to / loaded from raw int32 .bin files (reference
src/generator_ETHZ.cu:38-94), with the same filename scheme as main.cu:118-159
("unique_<n>.bin", "unique_skew<z>_S<n>.bin", "nonUnique_{R,S}<n>.bin",
"pk_R<n>.bin", "fk_S<n>_pk_R<n>.bin").

Generation itself lives in icde2019_gpu_join.datagen (C++ with exact
glibc rand()/nrand48() semantics, numpy fallback).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def cache_dir() -> str:
    d = os.environ.get("JOIN_DATA_DIR", os.path.join(os.getcwd(), "data"))
    os.makedirs(d, exist_ok=True)
    return d


def read_bin(path: str, n: int) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    arr = np.fromfile(path, dtype=np.int32, count=n)
    if arr.shape[0] != n:
        return None
    return arr


def write_bin(path: str, arr: np.ndarray):
    arr.astype(np.int32).tofile(path)


def unique_filename(n: int) -> str:
    return os.path.join(cache_dir(), f"unique_{n}.bin")


def zipf_filename(n: int, skew: float) -> str:
    # NB: the reference's sprintf has a format-arg bug here
    # (src/main.cu:139: "unique_skew%.2f_S%lu.bin" with one arg) — we use the
    # intended scheme with both fields.
    return os.path.join(cache_dir(), f"unique_skew{skew:.2f}_S{n}.bin")


def nonunique_filename(side: str, n: int) -> str:
    return os.path.join(cache_dir(), f"nonUnique_{side}{n}.bin")


def pk_filename(n: int) -> str:
    return os.path.join(cache_dir(), f"pk_R{n}.bin")


def fk_filename(n_s: int, n_r: int) -> str:
    return os.path.join(cache_dir(), f"fk_S{n_s}_pk_R{n_r}.bin")


def _cached(path: str, n: int, gen_fn) -> np.ndarray:
    arr = read_bin(path, n)
    if arr is not None:
        return arr
    arr = gen_fn()
    write_bin(path, arr)
    return arr


def create_relation_unique(n: int, maxid: Optional[int] = None, seed: int = 12345) -> np.ndarray:
    """Unique keys 0..maxid cycled then Knuth-shuffled
    (reference random_unique_gen, src/generator_ETHZ.cu:127-149)."""
    from icde2019_gpu_join import datagen

    maxid = n if maxid is None else maxid
    # int32 key domain: the engine's sentinel contract needs keys >= 0, so
    # the key cycle must stay below 2^31 (relevant only for 2B-row nominal
    # runs; the reference's int keys would overflow the same way)
    maxid = min(maxid, (1 << 31) - 2)
    return _cached(unique_filename(n), n, lambda: datagen.random_unique_gen(n, maxid, seed))


def create_relation_nonunique(path: str, n: int, maxid: int, seed: int = 12345) -> np.ndarray:
    from icde2019_gpu_join import datagen

    return _cached(path, n, lambda: datagen.random_gen(n, maxid, seed))


def create_relation_zipf(n: int, alphabet_size: int, z: float, seed: int = 12345) -> np.ndarray:
    from icde2019_gpu_join import datagen

    return _cached(zipf_filename(n, z), n, lambda: datagen.gen_zipf(n, alphabet_size, z, seed))


def create_relation_fk_from_pk(n_s: int, pk: np.ndarray, seed: int = 12345) -> np.ndarray:
    from icde2019_gpu_join import datagen

    return _cached(
        fk_filename(n_s, pk.shape[0]), n_s, lambda: datagen.fk_from_pk(n_s, pk, seed)
    )


def make_pk_fk(
    n_r: int, n_s: int, skew: float = 0.0, seed: int = 12345
) -> Tuple[np.ndarray, np.ndarray]:
    """The benchmark workload: unique R (PK), S foreign keys drawn from R's
    domain — uniform (unique_gen cycling 0..n_r) or Zipf over 1..n_r
    (reference main.cu:186-262 dispatch)."""
    r = create_relation_unique(n_r, n_r, seed)
    if skew > 0:
        s = create_relation_zipf(n_s, n_r, skew, seed)
    else:
        from icde2019_gpu_join import datagen

        s = _cached(
            os.path.join(cache_dir(), f"unique_S{n_s}_mod{n_r}.bin"),
            n_s,
            lambda: datagen.random_unique_gen(
                n_s, min(n_r, (1 << 31) - 2), seed + 1),
        )
    return r, s


def create_relation_n(base: np.ndarray, multiplier: int) -> np.ndarray:
    """Tile a relation `multiplier` times (create_relation_n,
    reference src/generator_ETHZ.cu:97-109 — the shuffle there is commented
    out, so plain tiling matches the reference exactly). Used by the
    -x/-y size-multiplier CLI flags (main.cu:103-105, 212, 245)."""
    return np.tile(np.asarray(base, dtype=np.int32), int(multiplier))


def pkfk_oracle_count(rk, sk, scale: int, skew: float,
                      seed: int = 12345) -> int:
    """Host-oracle SUM(1*1) — the match count, int32 wraparound — of the
    make_pk_fk(2^scale, 2^scale, skew, seed) workload with ones payloads.

    Looked up in the checkout's data/ directory (records for the 2^27
    uniform and Zipf z=1.05 workloads are checked in), then in cache_dir();
    otherwise computed by the host oracle and recorded in cache_dir(). The
    record is keyed by the dataset config AND the generator that made the
    data: the numpy fallback matches the native generator's distributions
    but not its bits, so a record from one generator never gates data from
    the other."""
    import json

    from icde2019_gpu_join import datagen

    gen = "native" if datagen.native_lib() is not None else "numpy"
    name = f"oracle_agg_pkfk_s{scale}_z{float(skew)}_seed{seed}_g{gen}.json"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for d in (os.path.join(repo, "data"), cache_dir()):
        path = os.path.join(d, name)
        if os.path.exists(path):
            with open(path) as f:
                return int(json.load(f)["aggregate"])
    agg = datagen.host_oracle_aggregate(
        rk, np.ones(rk.size, np.int32), sk, np.ones(sk.size, np.int32))
    with open(path, "w") as f:
        json.dump({"aggregate": agg, "n_r": int(rk.size),
                   "n_s": int(sk.size), "skew": float(skew), "seed": seed,
                   "generator": gen}, f)
    return agg
