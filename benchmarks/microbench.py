"""Microbenchmarks of candidate device primitives for the partition engine.

Measures, on the real chip, the achievable rates of every primitive a
radix-partition design could be built from, so kernel design decisions are
data-driven (not guessed):

  sort2/sort3    jax.lax.sort with 2/3 int32 operands (current v1 engine)
  take           jnp.take by a random permutation (gather)
  scatter        .at[perm].set (scatter by permutation)
  hist_bincount  jnp.bincount over 2^13 partitions
  hist_onehot    one-hot matmul histogram (MXU route)
  searchsorted   CSR offsets from sorted pids
  argsort        jnp.argsort int32

Run: python benchmarks/microbench.py [log2_n]
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, reps=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    lg = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    n = 1 << lg
    rng = np.random.RandomState(0)
    keys = jnp.asarray(rng.randint(0, 1 << 30, n, dtype=np.int32))
    pay = jnp.asarray(np.arange(n, dtype=np.int32))
    perm = jnp.asarray(rng.permutation(n).astype(np.int32))
    pid = keys & ((1 << 13) - 1)

    gbps = lambda nbytes, t: nbytes / t / 1e9

    r = {}

    f = jax.jit(lambda p, k, v: jax.lax.sort((p, k, v), num_keys=1, is_stable=True))
    t = timeit(f, pid, keys, pay)
    r["sort3"] = (t, gbps(n * 12 * 2, t))

    f = jax.jit(lambda k, v: jax.lax.sort((k, v), num_keys=1, is_stable=True))
    t = timeit(f, keys, pay)
    r["sort2"] = (t, gbps(n * 8 * 2, t))

    f = jax.jit(lambda x, i: jnp.take(x, i))
    t = timeit(f, keys, perm)
    r["take"] = (t, gbps(n * 8, t))

    f = jax.jit(lambda x, i: jnp.zeros_like(x).at[i].set(x))
    t = timeit(f, keys, perm)
    r["scatter_set"] = (t, gbps(n * 8, t))

    f = jax.jit(lambda p: jnp.bincount(p, length=1 << 13))
    t = timeit(f, pid)
    r["hist_bincount_8k"] = (t, gbps(n * 4, t))

    f = jax.jit(lambda p: jnp.bincount(p, length=32))
    t = timeit(f, keys & 31)
    r["hist_bincount_32"] = (t, gbps(n * 4, t))

    def onehot_hist(p):
        oh = jax.nn.one_hot(p & 255, 256, dtype=jnp.bfloat16)
        return jnp.sum(oh, axis=0)

    t = timeit(jax.jit(onehot_hist), pid)
    r["hist_onehot_256"] = (t, gbps(n * 4, t))

    ps = jax.jit(lambda p, k, v: jax.lax.sort((p, k, v), num_keys=1))(pid, keys, pay)[0]
    f = jax.jit(lambda s: jnp.searchsorted(s, jnp.arange((1 << 13) + 1, dtype=jnp.int32)))
    t = timeit(f, ps)
    r["searchsorted_8k"] = (t, gbps(n * 4, t))

    f = jax.jit(lambda k: jnp.argsort(k))
    t = timeit(f, keys)
    r["argsort"] = (t, gbps(n * 8, t))

    # cumsum over [tiles, parts] histogram matrix
    hists = jnp.ones((n // 8192, 8192), jnp.int32)
    f = jax.jit(lambda h: jnp.cumsum(h, axis=0))
    t = timeit(f, hists)
    r["hist_cumsum"] = (t, gbps(hists.size * 8, t))

    dev = jax.devices()[0].device_kind
    print(f"device={dev} n=2^{lg}")
    for k, (t, bw) in r.items():
        print(f"  {k:20s} {t*1e3:9.3f} ms   {bw:8.1f} GB/s-effective")


if __name__ == "__main__":
    main()
