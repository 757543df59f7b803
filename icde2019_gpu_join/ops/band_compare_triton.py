"""Hand-written GPU kernel for one chunk of the "mul" banded probe.

Drop-in for ops.band_join.chunk_compare_sum (its reference, and the path
off the GPU), written with Pallas on the Triton route; the probe takes it
when the default backend is a GPU, where it measured faster end to end
(docs/DESIGN_NOTES.md, GPU bring-up).

One program per S block: it loads the block's 128 keys and payloads by id,
then the W R-blocks of its window by index (base + w, masked at `his`), so
the [CH, W*128] window copies that the plain version gathers never reach
device memory. The 128 x 128 compare and multiply stay in registers; each
program writes one int32 partial and a jnp.sum reduces them. No program
accumulates across blocks.

All arithmetic is int32 with wraparound, bit-identical to the reference's
uint32 mod 2^32 aggregate.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_BLK = 128


def _kernel(ids_ref, base_ref, his_ref, act_ref, s_sv_ref, s_pay_ref,
            r_sv_ref, r_pay_ref, out_ref, *, window_blocks: int, nrb: int):
    sid = ids_ref[0]
    sk = s_sv_ref[pl.ds(sid, 1), :]                  # [1, 128]
    sp = s_pay_ref[pl.ds(sid, 1), :]
    base = base_ref[0]
    his = his_ref[0]
    act = act_ref[0] != 0
    per_s = jnp.zeros((_BLK, 1), jnp.int32)
    for w in range(window_blocks):
        rb = base + w
        rbc = jnp.minimum(jnp.maximum(rb, 0), nrb - 1)
        rk = r_sv_ref[pl.ds(rbc, 1), :]              # [1, 128]
        rp = r_pay_ref[pl.ds(rbc, 1), :]
        rp = jnp.where((rb < his) & act, rp, 0)
        eq = sk.reshape(_BLK, 1) == rk               # [128, 128]
        per_s = per_s + jnp.sum(jnp.where(eq, rp, 0), axis=1, keepdims=True)
    out_ref[0] = jnp.sum(per_s * sp.reshape(_BLK, 1))


@functools.partial(jax.jit, static_argnames=("window_blocks", "interpret"))
def chunk_compare_sum_triton(s_svb, s_payb, r_svb, r_payb, ids, base, his,
                             active, window_blocks: int,
                             interpret: bool = False):
    """Same contract as ops.band_join.chunk_compare_sum (uint32 result)."""
    ch = ids.shape[0]
    args = (ids, base, his, active.astype(jnp.int32), s_svb, s_payb, r_svb,
            r_payb)
    # inside shard_map the partials vary over the axes the inputs vary over
    vma = frozenset().union(*(jax.typeof(a).vma for a in args))
    one = pl.BlockSpec((1,), lambda i: (i,))
    parts = pl.pallas_call(
        functools.partial(_kernel, window_blocks=window_blocks,
                          nrb=r_svb.shape[0]),
        out_shape=jax.ShapeDtypeStruct((ch,), jnp.int32, vma=vma),
        grid=(ch,),
        in_specs=[one] * 4 + [pl.BlockSpec()] * 4,
        out_specs=one,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="banded_compare_sum_triton",
    )(*args)
    return jnp.sum(parts.astype(jnp.uint32), dtype=jnp.uint32)
