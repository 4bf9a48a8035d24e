"""Fused per-measurement normalizer + top-k1 detection select (Pallas,
Triton route).

Replaces preUpdateSynthKernel + the normalizer and selection stages of
phdUpdateKernel (src/phdfilter.cu:1824-1925, 2190-2245), which ran one
thread block per particle with threads looping over features. Here one
program holds one particle's F features (F padded to a power of two) and
loops over the measurements. Per (particle, measurement) it computes

  - sum_exp[p, m] = sum_f exp(log pd + log w + log N(z_m - h_f; S_f))
    (the per-measurement PHD normalizer numerator)
  - the k1 strongest *normalized, pruned* detection terms with their
    updated means and the channels the merge needs
    (w, mx, my, u00, u01, u11, log(pd*w)).

The XLA path (filter/update.py) writes the [P, M, F] log-likelihoods and
weights to device memory several times and runs ``lax.top_k`` over P*M
rows; here the [P, F] channels are read once, every [M, F] intermediate
stays in registers, and each pick is one row argmax plus a gather of the
winning feature's payload.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from phdslam_tpu.ops.linalg import wrap_angle

LOG_2PI = 1.8378770664093453
NEG_LARGE = -1e30

# One particle per program; warps per program chosen by measurement at
# the dense shape (P=8192, F=512, M=64; see PERF.md).
NUM_WARPS = 1


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _kernel(nv_ref, zr_ref, zb_ref, r_ref, b_ref, lpw_ref, si00_ref,
            si01_ref, si11_ref, lds_ref, mx_ref, my_ref, g00_ref, g01_ref,
            g10_ref, g11_ref, u00_ref, u01_ref, u11_ref,
            sum_ref, compat_ref, wsel_ref, mxsel_ref, mysel_ref,
            u00sel_ref, u01sel_ref, u11sel_ref, lpwsel_ref,
            *, n_measure: int, k1: int, clutter_birth: float,
            min_weight: float, gate_threshold: float, raw: bool,
            with_compat: bool, with_lpw: bool):
    r = r_ref[...]
    b = b_ref[...]
    lpw = lpw_ref[...]
    base = lpw - LOG_2PI - 0.5 * lds_ref[...]
    si00 = si00_ref[...]
    si01 = si01_ref[...]
    si11 = si11_ref[...]
    in_rng = lpw > (0.5 * NEG_LARGE)
    bp, fp = r.shape
    kp = wsel_ref.shape[2]
    rows = jax.lax.broadcasted_iota(jnp.int32, (bp,), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (bp, fp), 1)
    slot = jax.lax.broadcasted_iota(jnp.int32, (bp, kp), 1)
    sel_refs = (wsel_ref, mxsel_ref, mysel_ref, u00sel_ref, u01sel_ref,
                u11sel_ref, lpwsel_ref)
    zero_row = jnp.zeros((bp,), r.dtype)
    zero_tile = jnp.zeros((bp, kp), r.dtype)

    def one_measurement(m, carry):
        zr = zr_ref[m]
        zb = zb_ref[m]
        ir = zr - r
        ib = wrap_angle(zb - b)
        # nonnegative by definition; float32-indefinite covariances can
        # make the raw quadratic hugely negative -> exp overflow
        dist = jnp.maximum(
            ir * ir * si00 + 2.0 * ir * ib * si01 + ib * ib * si11, 0.0)
        e = jnp.exp(base - 0.5 * dist)                      # [bp, fp]
        s = jnp.sum(e, axis=1)                              # [bp]
        sum_ref[:, m] = s
        # birth gating: some in-range feature inside the innovation gate
        compat_ref[:, m] = (jnp.max(
            jnp.where(in_rng & (dist < gate_threshold), 1.0, 0.0), axis=1)
            if with_compat else zero_row)
        if raw:
            # unnormalized detection terms for callers with their own
            # normalizer (CPHD, mixed); the picks are invariant to any
            # positive per-(p, m) scale
            wrem = e
        else:
            wrem = e * (1.0 / (s + clutter_birth))[:, None]
            wrem = jnp.where(wrem >= min_weight, wrem, 0.0)

        outs = [zero_tile] * 7
        for j in range(k1):
            mval = jnp.max(wrem, axis=1)                    # [bp]
            idx = jnp.argmax(wrem, axis=1).astype(jnp.int32)  # first max
            take = lambda ref: ref[rows, idx]
            pr = zr - take(r_ref)
            pb = wrap_angle(zb - take(b_ref))
            vals = (jnp.maximum(mval, 0.0),
                    take(mx_ref) + take(g00_ref) * pr + take(g01_ref) * pb,
                    take(my_ref) + take(g10_ref) * pr + take(g11_ref) * pb,
                    take(u00_ref), take(u01_ref), take(u11_ref),
                    take(lpw_ref) if with_lpw else zero_row)
            outs = [jnp.where(slot == j, v[:, None], o)
                    for v, o in zip(vals, outs)]
            wrem = jnp.where(cols == idx[:, None], 0.0, wrem)
        for ref, o in zip(sel_refs, outs):
            ref[:, m, :] = o
        return carry

    def no_measurement(m, carry):
        # columns at or beyond the valid count are zeros
        sum_ref[:, m] = zero_row
        compat_ref[:, m] = zero_row
        for ref in sel_refs:
            ref[:, m, :] = zero_tile
        return carry

    nv = jnp.minimum(nv_ref[0], n_measure)
    jax.lax.fori_loop(0, nv, one_measurement, 0)
    jax.lax.fori_loop(nv, sum_ref.shape[1], no_measurement, 0)


@functools.partial(jax.jit, static_argnums=(3,),
                   static_argnames=("k1", "interpret", "raw", "with_compat",
                                    "with_lpw"))
def fused_update_select(z_rb, pre, gm, cfg, k1: int = 8,
                        interpret: bool = False, raw: bool = False,
                        n_valid=None, with_compat: bool = None,
                        with_lpw: bool = None):
    """Run the fused select. pre: filter.update.PreUpdate channels; gm:
    Gaussian2DMixture. Returns (sum_exp [P,M], w_sel, mx_sel, my_sel,
    u00_sel, u01_sel, u11_sel, lpw_sel — each [P,M,k1] — and compat [P,M]
    bool: some in-range feature within cfg.gateThreshold of the
    measurement, for birth gating).

    raw=True returns unnormalized, unpruned detection values
    (w_sel = exp(lw)) for callers with their own normalizers.

    Measurement columns at index >= n_valid (a traced int32 scalar; the
    1 + last valid index works for non-contiguous masks) are zeros; any
    interior invalid columns below n_valid are computed, and callers mask
    with z_valid exactly as in the XLA path. Outputs a caller does not use
    are skipped (with_compat defaults to cfg.gateBirths, with_lpw to
    particleWeighting == 2) and come back as zeros.
    """
    from phdslam_tpu.ops.linalg import safe_log

    if with_compat is None:
        with_compat = bool(cfg.gateBirths)
    if with_lpw is None:
        with_lpw = cfg.particleWeighting == 2

    P, F0 = pre.r.shape
    M = z_rb.shape[0]
    lpw = jnp.maximum(safe_log(pre.pd) + safe_log(gm.w), NEG_LARGE)
    chans = [pre.r, pre.bearing, lpw, pre.si00, pre.si01, pre.si11,
             pre.log_det_s, gm.mx, gm.my, pre.g00, pre.g01, pre.g10,
             pre.g11, pre.u00, pre.u01, pre.u11]
    # pad features to a power of two with benign geometry and
    # lpw = NEG_LARGE: exp underflows to 0, so padded slots add nothing to
    # the sums and are never picked over a live one
    fp = next_pow2(F0)
    chans = [jnp.pad(c, ((0, 0), (0, fp - F0)),
                     constant_values=NEG_LARGE if i == 2 else
                     (1.0 if i in (3, 5) else 0.0))
             for i, c in enumerate(chans)]
    mp = next_pow2(M)
    kp = next_pow2(k1)
    zr = jnp.pad(z_rb[:, 0], (0, mp - M))
    zb = jnp.pad(z_rb[:, 1], (0, mp - M))
    nv = jnp.full((1,), M, jnp.int32) if n_valid is None \
        else jnp.asarray(n_valid, jnp.int32).reshape(1)

    dtype = pre.r.dtype
    vec = lambda n: pl.BlockSpec((n,), lambda i: (0,))
    chan = pl.BlockSpec((1, fp), lambda i: (i, 0))
    out_mp = pl.BlockSpec((1, mp), lambda i: (i, 0))
    out_mkp = pl.BlockSpec((1, mp, kp), lambda i: (i, 0, 0))
    outs = pl.pallas_call(
        functools.partial(
            _kernel, n_measure=M, k1=k1,
            clutter_birth=float(cfg.clutterDensity + cfg.birthWeight),
            min_weight=float(cfg.minFeatureWeight),
            gate_threshold=float(cfg.gateThreshold), raw=raw,
            with_compat=with_compat, with_lpw=with_lpw),
        grid=(P,),
        in_specs=[vec(1), vec(mp), vec(mp)] + [chan] * 16,
        out_specs=[out_mp, out_mp] + [out_mkp] * 7,
        out_shape=[jax.ShapeDtypeStruct((P, mp), dtype)] * 2
        + [jax.ShapeDtypeStruct((P, mp, kp), dtype)] * 7,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="fused_update_select",
    )(nv, zr, zb, *chans)
    sum_exp = outs[0][:, :M]
    compat = outs[1][:, :M] > 0.5
    sel = [o[:, :M, :k1] for o in outs[2:]]
    return (sum_exp,) + tuple(sel) + (compat,)


def select_reference(z_rb, pre, gm, cfg, k1: int = 8, raw: bool = False,
                     n_valid=None, with_compat: bool = None,
                     with_lpw: bool = None):
    """The plain XLA computation of ``fused_update_select``'s outputs
    (filter/update.py's XLA branch): [P, M, F] log-weights, ``lax.top_k``
    and gathers. Same arguments and return tuple; payloads of zero-weight
    picks are arbitrary in both."""
    from phdslam_tpu.filter.update import (detection_log_weights,
                                           gather_selected)
    from phdslam_tpu.ops.linalg import safe_log

    if with_compat is None:
        with_compat = bool(cfg.gateBirths)
    if with_lpw is None:
        with_lpw = cfg.particleWeighting == 2
    M = z_rb.shape[0]
    n = M if n_valid is None else n_valid
    z_valid = jnp.arange(M) < n
    lw = detection_log_weights(pre, gm, z_rb, jnp.zeros((M,), jnp.int32),
                               z_valid, cfg)
    e = jnp.exp(lw)
    sum_exp = jnp.sum(e, axis=-1)
    if raw:
        w_det = e
    else:
        w_det = e / (sum_exp + cfg.clutterDensity + cfg.birthWeight)[..., None]
        w_det = jnp.where(w_det >= cfg.minFeatureWeight, w_det, 0.0)
    w_sel, f_sel = jax.lax.top_k(w_det, k1)
    mx, my, u00, u01, u11, lpw = gather_selected(pre, gm, z_rb, f_sel)
    zeros = jnp.zeros_like(w_sel)
    dist = -2.0 * (lw - safe_log(pre.pd)[:, None, :]
                   - safe_log(gm.w)[:, None, :] + LOG_2PI
                   + 0.5 * pre.log_det_s[:, None, :])
    compat = jnp.any((dist < cfg.gateThreshold)
                     & (pre.rclass == 1)[:, None, :], axis=-1)
    return (sum_exp, w_sel, mx, my, u00, u01, u11,
            lpw if with_lpw else zeros,
            compat if with_compat else jnp.zeros_like(compat))
