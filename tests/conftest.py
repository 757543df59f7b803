"""Test config: force CPU with 8 virtual devices so multi-device sharding
logic runs under pytest without several GPUs (SURVEY.md §4 item 4). Must
run before jax is imported anywhere."""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# wins even if a plugin imported jax before this file set the variable, as
# long as no computation has run yet
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(1234)


def make_tables(rng, n_r=1000, n_s=4000, key_range=None, dup_build=False):
    """Small random (R, S) tables with matches guaranteed."""
    key_range = key_range or n_r * 2
    if dup_build:
        r_keys = rng.randint(0, key_range, size=n_r).astype(np.int32)
    else:
        r_keys = rng.permutation(key_range)[:n_r].astype(np.int32)
    s_keys = r_keys[rng.randint(0, n_r, size=n_s)].astype(np.int32)
    # mix in some non-matching keys
    miss = rng.randint(0, n_s, size=n_s // 4)
    s_keys[miss] = (rng.randint(0, key_range, size=miss.shape[0]) + key_range).astype(
        np.int32
    )
    r_pay = rng.randint(-(2**31), 2**31, size=n_r).astype(np.int64).astype(np.int32)
    s_pay = rng.randint(-(2**31), 2**31, size=n_s).astype(np.int64).astype(np.int32)
    return r_keys, r_pay, s_keys, s_pay
