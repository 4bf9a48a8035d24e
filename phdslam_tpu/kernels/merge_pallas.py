"""Exact greedy Gaussian-mixture merge (Pallas, Triton route).

On-chip version of ops/gm.py:greedy_merge_channels (metric 0, Mahalanobis
with averaged covariance — the reference's default distance,
device_math.cuh:computeMahalDist — or metric 1, Hellinger). The design is
the reference's phdUpdateMergeKernel<<<P, 256>>>: one program per
particle holds the particle's whole candidate pool in registers, and a
while loop makes one greedy pick per iteration:

  pick   = row argmax of the remaining weights (first index on ties)
  sel    = candidates within min_separation of the pick
  output = moment-matched merge of sel
  w_rem  = weights of sel zeroed

Device memory sees one read of the candidates and one write of the
result. The XLA while_loop form re-reads all six [P, K] channels from
device memory on every pick. Picks run serially within a particle and
particles run in parallel across the SMs. Exact sequential-greedy
semantics; parity with the XLA path is tested in interpret mode
(tests/test_pallas.py) and on the card (chip_smoke.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from phdslam_tpu.kernels.preupdate_pallas import next_pow2

# One particle per program; warps per program chosen by measurement on
# the dense pool [8192, 1088] -> 512 (PERF.md).
NUM_WARPS = 4


def _kernel(w_ref, mx_ref, my_ref, c00_ref, c01_ref, c11_ref,
            ow_ref, omx_ref, omy_ref, o00_ref, o01_ref, o11_ref,
            *, cap: int, min_separation: float, metric: int):
    w0 = w_ref[...]
    mx = mx_ref[...]
    my = my_ref[...]
    c00 = c00_ref[...]
    c01 = c01_ref[...]
    c11 = c11_ref[...]
    bp, kp = w0.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (bp,), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (bp, kp), 1)
    out_refs = (ow_ref, omx_ref, omy_ref, o00_ref, o01_ref, o11_ref)

    def body(carry):
        i, w_rem, mval = carry
        pick = jnp.argmax(w_rem, axis=1).astype(jnp.int32)   # [bp]
        take = lambda ref: ref[rows, pick]
        pmx, pmy = take(mx_ref), take(my_ref)                 # [bp]
        rmx, rmy = pmx[:, None], pmy[:, None]
        r00, r01, r11 = (take(c00_ref)[:, None], take(c01_ref)[:, None],
                         take(c11_ref)[:, None])
        dx = rmx - mx
        dy = rmy - my
        dx2 = dx * dx
        dxy = dx * dy
        dy2 = dy * dy
        if metric == 1:
            # Hellinger (device_math.cuh:388-413), the XLA path's
            # arithmetic in ops/gm.py
            s00, s01, s11 = r00 + c00, r01 + c01, r11 + c11
            det_sum = s00 * s11 - s01 * s01
            safe = jnp.maximum(det_sum, 1.17549435e-38)
            eps_q = -0.25 * (dx2 * s11 - 2.0 * dxy * s01
                             + dy2 * s00) / safe
            det_prod = ((r00 * c00 + r01 * c01) * (r01 * c01 + r11 * c11)
                        - (r00 * c01 + r01 * c11)
                        * (r01 * c00 + r11 * c01))
            dist = 1.0 - jnp.sqrt(
                jnp.maximum(jnp.sqrt(jnp.maximum(det_prod, 0.0))
                            / (det_sum / 4.0), 0.0)) * jnp.exp(eps_q)
        else:
            a00 = 0.5 * (r00 + c00)
            a01 = 0.5 * (r01 + c01)
            a11 = 0.5 * (r11 + c11)
            det = a00 * a11 - a01 * a01
            dist = (dx2 * a11 - 2.0 * dxy * a01 + dy2 * a00) / det
        sel = ((dist < min_separation) & (w_rem > 0.0)) \
            | (cols == pick[:, None])
        sel = sel & (mval > 0.0)[:, None]
        sw = jnp.where(sel, w_rem, 0.0)
        wsum = jnp.sum(sw, axis=1)                             # [bp]
        inv = jnp.where(wsum > 0.0, 1.0 / jnp.maximum(wsum, 1e-38), 0.0)
        # one-pass moments centred on the picked mean: cluster members
        # sit within the separation gate of the pick, so E[x^2]-E[x]^2 in
        # centred coordinates loses no precision, and all six sums are
        # independent reductions
        mcx = jnp.sum(sw * dx, axis=1) * inv
        mcy = jnp.sum(sw * dy, axis=1) * inv
        n00 = jnp.sum(sw * (c00 + dx2), axis=1) * inv - mcx * mcx
        n01 = jnp.sum(sw * (c01 + dxy), axis=1) * inv - mcx * mcy
        n11 = jnp.sum(sw * (c11 + dy2), axis=1) * inv - mcy * mcy
        live = wsum > 0.0
        # exhausted rows emit the empty slot: weight 0, identity cov
        vals = (wsum, jnp.where(live, pmx - mcx, 0.0),
                jnp.where(live, pmy - mcy, 0.0),
                jnp.where(live, n00, 1.0), n01, jnp.where(live, n11, 1.0))
        for ref, v in zip(out_refs, vals):
            ref[:, i] = v
        w_next = jnp.where(sel, 0.0, w_rem)
        return i + 1, w_next, jnp.max(w_next, axis=1)

    def cond(carry):
        i, _, mval = carry
        return (i < cap) & (jnp.max(mval) > 0.0)

    n, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), w0, jnp.max(w0, axis=1)))

    empty = (0.0, 0.0, 0.0, 1.0, 0.0, 1.0)

    def fill(i, carry):
        for ref, v in zip(out_refs, empty):
            ref[:, i] = jnp.full((bp,), v, w0.dtype)
        return carry

    jax.lax.fori_loop(n, cap, fill, 0)


@functools.partial(jax.jit,
                   static_argnames=("min_separation", "max_out",
                                    "interpret", "metric"))
def greedy_merge_pallas(w, mx, my, c00, c01, c11, min_separation,
                        max_out: int, interpret: bool = False,
                        metric: int = 0):
    """Drop-in for ops.gm.greedy_merge_channels (metric 0 or 1).

    w..c11: [P, K] candidate channels; returns six [P, max_out] channels.
    K pads to a power of two with zero-weight candidates, which never
    seed or join a cluster."""
    P, K0 = w.shape
    kp = next_pow2(K0)
    capp = next_pow2(max_out)
    ins = [jnp.pad(a, ((0, 0), (0, kp - K0)),
                   constant_values=1.0 if i in (3, 5) else 0.0)
           for i, a in enumerate((w, mx, my, c00, c01, c11))]
    chan = pl.BlockSpec((1, kp), lambda i: (i, 0))
    out = pl.BlockSpec((1, capp), lambda i: (i, 0))
    outs = pl.pallas_call(
        functools.partial(_kernel, cap=max_out,
                          min_separation=float(min_separation),
                          metric=int(metric)),
        grid=(P,),
        in_specs=[chan] * 6,
        out_specs=[out] * 6,
        out_shape=[jax.ShapeDtypeStruct((P, capp), w.dtype)] * 6,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="greedy_merge",
    )(*ins)
    return tuple(o[:, :max_out] for o in outs)
