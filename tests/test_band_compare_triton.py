"""The Triton candidate for the probe's "mul" chunk step (interpret mode on
the CPU) against the plain version it would replace."""

import jax.numpy as jnp
import numpy as np
import pytest

from icde2019_gpu_join.ops.band_compare_triton import chunk_compare_sum_triton
from icde2019_gpu_join.ops.band_join import chunk_compare_sum


@pytest.mark.parametrize("w", [1, 2])
def test_triton_chunk_matches_plain(w):
    r = np.random.RandomState(w)
    nsb, nrb, ch = 64, 80, 32
    s_svb = r.randint(0, 500, (nsb, 128)).astype(np.int32)
    s_payb = r.randint(-2**31, 2**31, (nsb, 128), dtype=np.int64).astype(
        np.int32)
    r_svb = np.sort(r.randint(0, 500, nrb * 128)).reshape(nrb, 128).astype(
        np.int32)
    r_payb = r.randint(-2**31, 2**31, (nrb, 128), dtype=np.int64).astype(
        np.int32)
    ids = r.randint(0, nsb, ch).astype(np.int32)
    base = r.randint(-1, nrb, ch).astype(np.int32)      # includes clamped
    his = (base + r.randint(0, 4, ch)).astype(np.int32)
    active = r.rand(ch) < 0.8
    args = [jnp.asarray(a) for a in (s_svb, s_payb, r_svb, r_payb, ids, base,
                                     his, active)]
    want = int(chunk_compare_sum(*args, w))
    got = int(chunk_compare_sum_triton(*args, window_blocks=w,
                                       interpret=True))
    assert got == want


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_chunk_step_choice_follows_backend(backend, monkeypatch):
    """The aggregate probe takes the Triton kernel exactly when the default
    backend is a GPU; the plain step everywhere else."""
    import jax

    from icde2019_gpu_join.ops import band_join as bj

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    want = chunk_compare_sum_triton if backend == "gpu" else chunk_compare_sum
    assert bj._chunk_sum_impl() is want
