"""GM-PHD measurement update, fully on-device with fixed shapes.

The static-shape re-design of the reference's update path
(src/phdfilter.cu:3336-3761):

  reference (dynamic shapes, host staging)      this module (static shapes)
  ------------------------------------------    ---------------------------
  computeInRangeKernel + host 3-way split       per-(P,F) range-class masks
  preUpdateSynthKernel (thread/feature x        channelized [P,F] Kalman
    loop over <=256 const-mem measurements)       terms + [P,M,F] likelihoods
  phdUpdateKernel (block/particle; update       per-(P,M) normalizers via
    array [nondet|detect|births])                 masked sums; weights stay
                                                  factored (nondet/det/birth)
  merge_flags + thrust prune                    weight thresholding (w -> 0)
  recombine + phdUpdateMergeKernel              two-stage top-K candidate
                                                  pool -> bounded greedy merge
  out-of-range pass-through concat              weight-ranked union back to
                                                  the padded [P,F] map

Layout: everything is channel-separated scalars ([P,F] / [P,K] arrays per
Gaussian field) — the structure-of-arrays form of the reference's
Maple-expanded 2x2 expressions (src/phdfilter.cu:332-364): every
elementwise pass reads contiguous [P,F] rows, and no array carries tiny
[2,2] minor dimensions.

Key structural observations exploited:
 - Kalman gain / updated covariance / innovation covariance depend only on
   the (particle, feature) pair — never on the measurement — so detection
   terms share per-feature covariances and only an [P,M,F] scalar
   log-likelihood is measurement-indexed.
 - Means of surviving detection terms are recomputed after top-K selection
   instead of materializing [P,M,F] Gaussians.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from phdslam_tpu.config import SlamConfig, STATIC_MEASUREMENT
from phdslam_tpu.filter.state import Gaussian2DMixture
from phdslam_tpu.models.measurement import predict_measurement, range_class
from phdslam_tpu.kernels import kernel_mode
from phdslam_tpu.ops.gm import greedy_merge_channels
from phdslam_tpu.ops.linalg import safe_log, wrap_angle

LOG_2PI = 1.8378770664093453


class PreUpdate(NamedTuple):
    """Measurement-independent Kalman terms per (particle, feature), all
    [P, F] scalar channels."""

    r: jax.Array
    bearing: jax.Array
    pd: jax.Array
    rclass: jax.Array            # 0=out, 1=in, 2=near (0 for empty slots)
    g00: jax.Array               # Kalman gain
    g01: jax.Array
    g10: jax.Array
    g11: jax.Array
    u00: jax.Array               # Joseph-form updated covariance
    u01: jax.Array
    u11: jax.Array
    si00: jax.Array              # innovation covariance inverse
    si01: jax.Array
    si11: jax.Array
    log_det_s: jax.Array


def kalman_preupdate(pose, gm: Gaussian2DMixture,
                     cfg: SlamConfig) -> PreUpdate:
    """Per-(P,F) EKF pre-update terms (src/phdfilter.cu:301-395).

    Channelized form of: S = J P J^T + R (symmetrized), K = P J^T S^-1,
    P' = (I-KJ) P (I-KJ)^T + K R K^T.
    """
    mean_xy = jnp.stack([gm.mx, gm.my], axis=-1)
    r, b, dx, dy, r2 = predict_measurement(pose[:, None, :], mean_xy)
    rc = range_class(r, b, cfg)
    rc = jnp.where(gm.valid, rc, 0)
    in_mask = rc == 1
    pd = jnp.where(in_mask, cfg.pd, 0.0).astype(gm.w.dtype)

    # For slots that take no part in the update (empty / not in range),
    # substitute a benign geometry (dx=1, dy=0) so every downstream Kalman
    # quantity stays finite — otherwise 0*inf NaNs would leak through the
    # masked weighted sums in the merge.
    dx = jnp.where(in_mask, dx, 1.0)
    dy = jnp.where(in_mask, dy, 0.0)
    r2s = dx * dx + dy * dy
    rs = jnp.sqrt(r2s)

    j00 = dx / rs
    j01 = dy / rs
    j10 = -dy / r2s
    j11 = dx / r2s

    p00, p01, p11 = gm.c00, gm.c01, gm.c11
    var_r = cfg.stdRange ** 2
    var_b = cfg.stdBearing ** 2

    # A = J P J^T (symmetric)
    a00 = j00 * (j00 * p00 + j01 * p01) + j01 * (j00 * p01 + j01 * p11)
    a01 = j10 * (j00 * p00 + j01 * p01) + j11 * (j00 * p01 + j01 * p11)
    a11 = j10 * (j10 * p00 + j11 * p01) + j11 * (j10 * p01 + j11 * p11)

    s00 = a00 + var_r
    s01 = a01
    s11 = a11 + var_b

    # Cancellation-free determinant. The naive s00*s11 - s01^2 suffers
    # catastrophic float32 cancellation once feature covariances grow, which
    # feeds garbage Kalman gains back into the covariances (runaway). For
    # PSD A = J P J^T and diagonal R:
    #   det(A + R) = det(A) + a00*var_b + a11*var_r + var_r*var_b
    # and det(A) = det(J)^2 det(P) = det(P) / r^2 (det(J) = 1/r for the
    # range-bearing Jacobian). Every term is nonnegative; det(R) is a valid
    # lower bound (det(X+Y) >= det(X)+det(Y) for PSD 2x2).
    det_p = jnp.maximum(p00 * p11 - p01 * p01, 0.0)
    det_s = (det_p / r2s + a00 * var_b + a11 * var_r + var_r * var_b)
    det_s = jnp.maximum(det_s, var_r * var_b)

    si00 = s11 / det_s
    si01 = -s01 / det_s
    si11 = s00 / det_s

    # K = P J^T S^-1, with T = P J^T
    t00 = p00 * j00 + p01 * j01
    t01 = p00 * j10 + p01 * j11
    t10 = p01 * j00 + p11 * j01
    t11 = p01 * j10 + p11 * j11
    g00 = t00 * si00 + t01 * si01
    g01 = t00 * si01 + t01 * si11
    g10 = t10 * si00 + t11 * si01
    g11 = t10 * si01 + t11 * si11

    # Joseph form: L = I - K J;  P' = L P L^T + K R K^T
    l00 = 1.0 - (g00 * j00 + g01 * j10)
    l01 = -(g00 * j01 + g01 * j11)
    l10 = -(g10 * j00 + g11 * j10)
    l11 = 1.0 - (g10 * j01 + g11 * j11)
    q00 = l00 * p00 + l01 * p01
    q01 = l00 * p01 + l01 * p11
    q10 = l10 * p00 + l11 * p01
    q11 = l10 * p01 + l11 * p11
    u00 = q00 * l00 + q01 * l01 + g00 * g00 * var_r + g01 * g01 * var_b
    u01 = q00 * l10 + q01 * l11 + g00 * g10 * var_r + g01 * g11 * var_b
    u11 = q10 * l10 + q11 * l11 + g10 * g10 * var_r + g11 * g11 * var_b

    return PreUpdate(
        r=r, bearing=b, pd=pd, rclass=rc,
        g00=g00, g01=g01, g10=g10, g11=g11,
        u00=u00, u01=u01, u11=u11,
        si00=si00, si01=si01, si11=si11,
        log_det_s=jnp.log(det_s))


def detection_log_weights(pre: PreUpdate, gm: Gaussian2DMixture, z_rb,
                          z_label, z_valid, cfg: SlamConfig):
    """Log partial weights of detection terms, [P, M, F]
    (src/phdfilter.cu:366-394):  log pd + log w + log N(innov; 0, S).

    Innovations are recomputed on demand (cheap: z - h(x)) instead of being
    materialized as a [P,M,F,2] tensor — at the dense-stress config that
    tensor alone is >2 GB of device memory.
    """
    innov_r = z_rb[None, :, None, 0] - pre.r[:, None, :]
    innov_b = wrap_angle(z_rb[None, :, None, 1] - pre.bearing[:, None, :])
    dist = (innov_r * innov_r * pre.si00[:, None, :]
            + 2.0 * innov_r * innov_b * pre.si01[:, None, :]
            + innov_b * innov_b * pre.si11[:, None, :])
    # a Mahalanobis quadratic is nonnegative by definition; float32 can
    # leave a near-singular covariance indefinite after merges, where the
    # raw quadratic goes hugely negative and exp() overflows (observed:
    # dist = -398 from si00 = -5.9 on a w=1e-3 component)
    dist = jnp.maximum(dist, 0.0)
    lw = (safe_log(pre.pd)[:, None, :]
          + safe_log(gm.w)[:, None, :]
          - 0.5 * dist
          - LOG_2PI
          - 0.5 * pre.log_det_s[:, None, :])
    in_mask = (pre.rclass == 1)[:, None, :]
    ok = in_mask & z_valid[None, :, None]
    if cfg.labeledMeasurements:
        ok = ok & (z_label[None, :, None] == STATIC_MEASUREMENT)
    neg_inf = jnp.asarray(-jnp.inf, lw.dtype)
    return jnp.where(ok, lw, neg_inf)


def gather_selected(pre: PreUpdate, gm: Gaussian2DMixture, z_rb, f_sel,
                    with_lpw: bool = True):
    """Reconstruct the merge-candidate payload channels from picked feature
    indices f_sel [P, M, k1].

    Every payload channel is measurement-independent per feature (updated
    covariance, Kalman gains, log pd*w), and the updated detection means
    are closed forms of the gains + the (measurement, feature) innovation —
    so selection only has to identify WHICH feature won; the payload is
    k1*M take_along_axis gathers from the [P, F] channels. Entries whose
    selected weight is zero carry arbitrary (finite) payload; callers kill
    them via the weight.
    """
    P, M, k1 = f_sel.shape
    take_sel = lambda a: jnp.take_along_axis(
        a[:, None, :], jnp.broadcast_to(f_sel, (P, M, k1)), axis=2)
    ir_sel = z_rb[None, :, None, 0] - take_sel(pre.r)
    ib_sel = wrap_angle(z_rb[None, :, None, 1] - take_sel(pre.bearing))
    mx_sel = take_sel(gm.mx) + take_sel(pre.g00) * ir_sel \
        + take_sel(pre.g01) * ib_sel
    my_sel = take_sel(gm.my) + take_sel(pre.g10) * ir_sel \
        + take_sel(pre.g11) * ib_sel
    # lpw only feeds particleWeighting == 2; skip its gather + logs
    # otherwise (mirrors the kernel's with_lpw dead-output elision)
    lpw_sel = (safe_log(take_sel(pre.pd)) + safe_log(take_sel(gm.w))
               if with_lpw else None)
    return (mx_sel, my_sel, take_sel(pre.u00), take_sel(pre.u01),
            take_sel(pre.u11), lpw_sel)


class UpdateResult(NamedTuple):
    map_out: Gaussian2DMixture   # merged + pass-through map, [P, F]
    log_weight_delta: jax.Array  # [P] multi-object likelihood increment
    # factored update-component weights, for variance estimation / debugging
    w_nondetect: jax.Array       # [P, F]
    w_detect: jax.Array          # [P, M, k1] selected terms
    w_birth: jax.Array           # [P, M]
    det_mass: jax.Array          # [P, M] total detection mass per z
    pre: PreUpdate               # measurement-independent Kalman terms


def phd_update_static(pose, gm: Gaussian2DMixture, z_rb, z_label, z_valid,
                      cfg: SlamConfig) -> UpdateResult:
    """Full static-model PHD update for all particles.

    pose [P,6]; gm: [P,F] channelized 2-D mixture; z_rb [M,2]; z_valid [M].

    Two equivalent backends (kernels.kernel_mode chooses):
      - kernel (GPU): the fused select reads the [P,F] channels once and
        emits normalizer numerators + the per-measurement top-k1 detection
        candidates with channels (kernels/preupdate_pallas.py)
      - XLA: materializes the [P,M,F] log-likelihoods and selects with
        top_k + gathers
    """
    P, F = gm.w.shape
    M = z_rb.shape[0]
    dtype = gm.w.dtype
    # fast mode (merge_mode=1) keeps the top-4 detection candidates per
    # measurement instead of 8: the k1 extraction loop dominates the fused
    # select kernel, and sub-top-4 candidates are overwhelmingly below the
    # fast prune threshold anyway (documented deviation; accuracy evidence
    # is the exact-vs-fast MC envelope in RESULTS.md)
    k1 = min(cfg.selectTopK or (4 if cfg.mergeMode == 1 else 8), F)

    pre = kalman_preupdate(pose, gm, cfg)

    use_pallas, interp = kernel_mode(cfg)
    if use_pallas:
        nv = jnp.max(jnp.where(z_valid, jnp.arange(M) + 1, 0))
        from phdslam_tpu.kernels.preupdate_pallas import fused_update_select
        (sum_exp, w_sel, mx_sel, my_sel, u00_sel, u01_sel, u11_sel,
         lpw_sel, compatible) = fused_update_select(z_rb, pre, gm, cfg,
                                                    k1=k1, n_valid=nv,
                                                    interpret=interp)
        # per-measurement validity/label gating (column masks)
        if cfg.labeledMeasurements:
            m_ok = z_valid & (z_label == STATIC_MEASUREMENT)
        else:
            m_ok = z_valid
        sum_exp = jnp.where(m_ok[None, :], sum_exp, 0.0)
        w_sel = jnp.where(m_ok[None, :, None], w_sel, 0.0)
    else:
        lw = detection_log_weights(pre, gm, z_rb, z_label, z_valid, cfg)
        sum_exp = jnp.sum(jnp.exp(lw), axis=-1)               # [P, M]
        # compatibility for birth gating (innovation distance gate)
        g_single = lw - safe_log(pre.pd)[:, None, :] \
            - safe_log(gm.w)[:, None, :]
        dist_mf = -2.0 * (g_single + LOG_2PI
                          + 0.5 * pre.log_det_s[:, None, :])
        compatible = jnp.any(
            (dist_mf < cfg.gateThreshold) & (pre.rclass == 1)[:, None, :],
            axis=-1)                                          # [P, M]

    # --- per-measurement normalizers (src/phdfilter.cu:2190-2223) ---
    birth_w_lin = jnp.asarray(cfg.birthWeight, dtype)
    if cfg.labeledMeasurements:
        birth_ok = (z_label == STATIC_MEASUREMENT)[None, :]
    else:
        birth_ok = jnp.ones((1, M), bool)
    normalizer = sum_exp + cfg.clutterDensity + birth_w_lin
    log_norm = safe_log(normalizer)                           # [P, M]

    # --- updated component weights (linear space) ---
    w_nondetect = jnp.where(pre.rclass == 1, gm.w * (1.0 - pre.pd), 0.0)
    if not use_pallas:
        w_detect = jnp.exp(lw - log_norm[..., None])          # [P, M, F]
    if cfg.gateBirths:
        # births only from measurements not explained by an existing
        # feature (the dormant birthsKernel gating, N23:
        # src/phdfilter.cu.bak:737-856)
        birth_ok = birth_ok & ~compatible
    w_birth = jnp.where(
        birth_ok & z_valid[None, :],
        birth_w_lin / normalizer, 0.0)                        # [P, M]

    # --- particle weighting (src/phdfilter.cu:2256-2305) ---
    mvalid = z_valid.astype(dtype)
    sum_log_norm = jnp.sum(log_norm * mvalid[None, :], axis=-1)   # [P]
    n_measure = jnp.sum(mvalid)
    if cfg.particleWeighting == 0:
        # cluster-process: sum log normalizers - predicted cardinality,
        # where cardinality counts pd*w for persistent + birthWeight per z.
        card_pred = (jnp.sum(pre.pd * gm.w, axis=-1)
                     + n_measure * birth_w_lin)
        dw = sum_log_norm - card_pred
    else:
        # Vo empty-map (scheme 1):
        #   m*clutterDensity + cn_update - cn_predict - clutterRate
        # total detection mass per measurement = sum_exp / normalizer
        in_mask = pre.rclass == 1
        cn_predict = jnp.sum(jnp.where(in_mask, gm.w, 0.0), axis=-1)
        cn_update = (jnp.sum(w_nondetect, axis=-1)
                     + jnp.sum(sum_exp / normalizer * mvalid[None, :],
                               axis=-1)
                     + jnp.sum(w_birth * mvalid[None, :], axis=-1))
        dw = (n_measure * cfg.clutterDensity + cn_update - cn_predict
              - cfg.clutterRate)

    # --- prune (merge flags, src/phdfilter.cu:2307-2319) ---
    minw = cfg.minFeatureWeight
    w_nd_p = jnp.where(w_nondetect >= minw, w_nondetect, 0.0)
    w_birth_p = jnp.where(w_birth >= minw, w_birth, 0.0)

    # --- merge candidate pool -------------------------------------------
    # Three mutually exclusive, gather-free sections (no global top-k or
    # row gathers at [P, M*F] scale):
    #   [0, F)           originals: non-detection terms for in-range
    #                    features, untouched weights for near/out-of-range
    #                    ones (the reference's out1 features bypass the
    #                    merge; here they participate — geometrically >1.2x
    #                    maxRange from every update candidate, so they only
    #                    ever co-cluster with each other, which is benign)
    #   [F, F + M*k1)    per-measurement top-k1 detection terms
    #   [F + M*k1, ...)  birth terms
    in_mask = pre.rclass == 1
    w_sec1 = jnp.where(in_mask, w_nd_p, gm.w)

    if not use_pallas:
        # per-measurement selection via top_k + small gathers along F
        w_det_p = jnp.where(w_detect >= minw, w_detect, 0.0)
        w_sel, f_sel = jax.lax.top_k(w_det_p, k1)             # [P,M,k1]
        (mx_sel, my_sel, u00_sel, u01_sel, u11_sel,
         lpw_sel) = gather_selected(pre, gm, z_rb, f_sel,
                                    with_lpw=cfg.particleWeighting == 2)
    else:
        # pallas path already pruned at minw inside the kernel
        pass

    # births, channelized closed form (computeBirth,
    # src/phdfilter.cu:205-242): J columns (cos t, sin t) and (-dy, dx) —
    # exact for zero/negative ranges too
    theta_b = pose[:, None, 2] + z_rb[None, :, 1]
    ct, st = jnp.cos(theta_b), jnp.sin(theta_b)
    bdx = z_rb[None, :, 0] * ct
    bdy = z_rb[None, :, 0] * st
    var_rb = (cfg.stdRange * cfg.birthNoiseFactor) ** 2
    var_bb = (cfg.stdBearing * cfg.birthNoiseFactor) ** 2

    flat = lambda a: a.reshape(P, M * k1)
    cat = lambda a, b, c: jnp.concatenate([a, b, c], axis=-1)
    cand_w = cat(w_sec1, flat(jnp.where(w_sel >= minw, w_sel, 0.0)),
                 w_birth_p)
    cand_mx = cat(gm.mx, flat(mx_sel), pose[:, None, 0] + bdx)
    cand_my = cat(gm.my, flat(my_sel), pose[:, None, 1] + bdy)
    cand_00 = cat(gm.c00, flat(u00_sel),
                  ct * ct * var_rb + bdy * bdy * var_bb)
    cand_01 = cat(gm.c01, flat(u01_sel),
                  ct * st * var_rb - bdy * bdx * var_bb)
    cand_11 = cat(gm.c11, flat(u11_sel),
                  st * st * var_rb + bdx * bdx * var_bb)

    # --- greedy merge (src/phdfilter.cu:2707-2898) ------------------------
    # the merged output IS the new padded map: no union/top-k compaction
    if cfg.mergeMode == 1:
        # fast mode: drop sub-mergeMinWeight candidates (their greedy trips
        # dominate the step) and renormalize mass — see ops/gm.py
        from phdslam_tpu.ops.gm import fast_prune_renormalize
        cand_w = fast_prune_renormalize(cand_w, cfg.mergeMinWeight)
    mw, mmx, mmy, m00, m01, m11 = greedy_merge_channels(
        cand_w, cand_mx, cand_my, cand_00, cand_01, cand_11,
        cfg.minSeparation, F, metric=cfg.distanceMetric,
        use_kernel=use_pallas, interpret=interp)
    map_out = Gaussian2DMixture(w=mw, mx=mmx, my=mmy, c00=m00, c01=m01,
                                c11=m11)

    if cfg.particleWeighting == 2:
        # Vo single-feature weighting (host-side path,
        # src/phdfilter.cu:3600-3660): pick the (measurement, feature) pair
        # with the highest single-object likelihood N(innov; S); the weight
        # factor compares predicted and updated PHD intensity at that
        # feature's updated mean:
        #   a = (1-pd)*kappa*m + pd*m*(m-1)*kappa*maxlik
        #   b = exp(cn_update - cn_predict - clutterRate)
        #   dlogw = log(a * v_predict(x*) / (b * v_update(x*)))
        lik_sel = w_sel * normalizer[:, :, None] / jnp.maximum(
            jnp.exp(lpw_sel), 1e-30)
        flat_lik = lik_sel.reshape(P, M * k1)
        best = jnp.argmax(flat_lik, axis=1)
        max_lik = jnp.take_along_axis(flat_lik, best[:, None], axis=1)[:, 0]
        x_star = jnp.take_along_axis(flat(mx_sel), best[:, None],
                                     axis=1)[:, 0]
        y_star = jnp.take_along_axis(flat(my_sel), best[:, None],
                                     axis=1)[:, 0]

        def intensity(mix, x, y):
            dxm = x[:, None] - mix.mx
            dym = y[:, None] - mix.my
            det = jnp.maximum(mix.c00 * mix.c11 - mix.c01 ** 2, 1e-12)
            maha = (dxm * dxm * mix.c11 - 2 * dxm * dym * mix.c01
                    + dym * dym * mix.c00) / det
            val = mix.w * jnp.exp(-0.5 * maha) / (
                2.0 * jnp.pi * jnp.sqrt(det))
            return jnp.sum(jnp.where(mix.w > 0, val, 0.0), axis=-1)

        v_predict = intensity(gm, x_star, y_star)
        v_update = intensity(map_out, x_star, y_star)
        cn_predict2 = jnp.sum(gm.w, axis=-1)
        cn_update2 = jnp.sum(map_out.w, axis=-1)
        a = ((1.0 - cfg.pd) * cfg.clutterDensity * n_measure
             + cfg.pd * n_measure * ((n_measure - 1.0)
                                     * cfg.clutterDensity * max_lik))
        b_fac = jnp.exp(cn_update2 - cn_predict2 - cfg.clutterRate)
        dw = safe_log((a * v_predict)
                      / jnp.maximum(b_fac * v_update, 1e-30))

    return UpdateResult(
        map_out=map_out,
        log_weight_delta=dw,
        w_nondetect=w_nondetect,
        w_detect=w_sel * mvalid[None, :, None],
        w_birth=w_birth * mvalid[None, :],
        det_mass=sum_exp / normalizer * mvalid[None, :],
        pre=pre,
    )


def phd_variance(result: UpdateResult, z_valid):
    """Per-particle variance of the updated map's target count
    (the role of phdVarianceKernel, src/phdfilter.cu:2643-2705).

    The reference kernel Monte-Carlo-samples each update component and sums
    val (non-detect) or val*(1-val) (detect/birth) where val is the
    *density* w*N(x;g) at x ~ g — but its evalGaussian exponentiates a
    POSITIVE quadratic (src/device_math.cuh:123-127), so its output is
    numerically meaningless. The statistic it aims for is Mahler's
    cardinality variance of a GM-PHD posterior, which is weight-based and
    closed-form:

        Var[N] = sum_nd w  +  sum_{detect,birth} w (1 - w)

    (non-detection legacy stays Poisson -> contributes its mean; each
    normalized detection/birth term is Bernoulli -> w(1-w)). We compute it
    exactly — no sampling, no RNG, strictly positive whenever the map is
    non-empty. The detection sum uses sum_f w(1-w) = mass - sum_f w^2 with
    the squared tail beyond the stored top-k1 terms dropped (those weights
    are the smallest; dropping their squares only tightens the bound).

    This statistic only feeds the exported logs (particles.variances),
    never the filter, so the step computes it optionally.
    """
    dtype = result.w_nondetect.dtype
    mvalid = z_valid.astype(dtype)                              # [M]
    var = jnp.sum(result.w_nondetect, axis=-1)                  # [P]
    det_sq = jnp.sum(result.w_detect ** 2, axis=-1)             # [P, M]
    var += jnp.sum(jnp.maximum(result.det_mass - det_sq, 0.0)
                   * mvalid[None, :], axis=-1)
    wb = result.w_birth
    var += jnp.sum(wb * (1.0 - wb) * mvalid[None, :], axis=-1)
    return var
