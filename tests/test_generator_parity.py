"""Generator bit-parity: byte-compare our native generator's streams
against the REFERENCE generator compiled from its own source
(/root/reference/src/generator_ETHZ.cu — plain CPU C++).

This replaces PARITY.md's previously unverified claim with a failing test:
any byte diff in uniform / unique / FK-from-PK / Zipf streams fails here.

Skips (does not silently pass) if the reference tree or g++ is missing.
"""

import os
import subprocess

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SRC = "/root/reference/src/generator_ETHZ.cu"
HARNESS = os.path.join(REPO, "tests", "golden", "ref_gen_harness.cpp")
BUILD_DIR = os.path.join(REPO, "tests", "golden", "build")
BIN = os.path.join(BUILD_DIR, "ref_gen")


def _build():
    if os.path.exists(BIN) and (
        os.path.getmtime(BIN) > max(os.path.getmtime(HARNESS),
                                    os.path.getmtime(REF_SRC))):
        return BIN
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [
        "g++", "-O2", "-x", "c++", REF_SRC, "-x", "c++", HARNESS,
        "-I", os.path.dirname(REF_SRC), "-o", BIN,
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return BIN


@pytest.fixture(scope="module")
def ref_gen():
    if not os.path.exists(REF_SRC):
        pytest.skip("reference tree not mounted")
    try:
        subprocess.run(["g++", "--version"], capture_output=True, check=True)
    except Exception:
        pytest.skip("no g++")
    return _build()


@pytest.fixture(scope="module")
def native():
    from icde2019_gpu_join import datagen
    if datagen.native_lib() is None:
        pytest.skip("native lib unavailable")
    return datagen


def _run_ref(ref_gen, tmp_path, *args):
    out = os.path.join(str(tmp_path), "ref.bin")
    subprocess.run([ref_gen, args[0], out, *map(str, args[1:])],
                   check=True, capture_output=True)
    return np.fromfile(out, dtype=np.int32)


@pytest.mark.parametrize("n,maxid,seed", [
    (100_000, 1 << 20, 12345),
    (65_537, 1000, 42),
])
def test_uniform_bit_parity(ref_gen, native, tmp_path, n, maxid, seed):
    ref = _run_ref(ref_gen, tmp_path, "uniform", n, maxid, seed)
    got = native.random_gen(n, maxid, seed=seed)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("n,maxid,seed", [
    (100_000, 99_999, 12345),     # n > maxid: wrapping cycle
    (50_000, 1 << 20, 7),         # n <= maxid
])
def test_unique_bit_parity(ref_gen, native, tmp_path, n, maxid, seed):
    ref = _run_ref(ref_gen, tmp_path, "unique", n, maxid, seed)
    got = native.random_unique_gen(n, maxid, seed=seed)
    assert np.array_equal(got, ref)


def test_fk_from_pk_bit_parity(ref_gen, native, tmp_path):
    n_pk, n_fk, seed = 10_000, 123_456, 12345
    pk = native.random_unique_gen(n_pk, n_pk - 1, seed=9)
    pk_path = os.path.join(str(tmp_path), "pk.bin")
    pk.tofile(pk_path)
    ref = _run_ref(ref_gen, tmp_path, "fk", n_fk, pk_path, n_pk, seed)
    got = native.fk_from_pk(n_fk, pk, seed=seed)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("n,alphabet,z,seed", [
    (200_000, 100_000, 1.05, 12345),
    (100_000, 4096, 0.5, 3),
])
def test_zipf_bit_parity(ref_gen, native, tmp_path, n, alphabet, z, seed):
    ref = _run_ref(ref_gen, tmp_path, "zipf", n, alphabet, z, seed)
    got = native.gen_zipf(n, alphabet, z, seed=seed)
    assert np.array_equal(got, ref)
