"""4-D (dynamic-feature) Gaussian machinery in channel layout, and the
MIXED static+dynamic PHD update.

Covers the reference's dynamic/mixed feature model:
 - Gaussian4D Kalman pre-update (computePreUpdate 4-D overload,
   src/phdfilter.cu:397-521): range-bearing measurement of the position
   block of a [x, y, vx, vy] state; Joseph-form covariance
 - 4-D births (computeBirth 4-D overload, :244-299)
 - phdUpdateKernelMixed (:2323-2635): per-measurement normalizers summing
   the static AND dynamic detection terms plus clutter and both birth
   weights (two birth terms when measurements are unlabeled, :2501-2503);
   predicted cardinality = sum of pd*w over both maps (the mixed kernel,
   unlike the static one, does not add m*birthWeight — and we use the
   per-particle feature weights where the reference reads
   features_predict_static[feature_idx] without the particle offset,
   :2410-2411, an indexing bug we do not replicate)
 - greedy merge of 4-D mixtures (phdUpdateMergeKernel via the Gaussian4D
   overloads; Mahalanobis with averaged covariances through a channelized
   4x4 Cholesky solve)

Layout: symmetric 4x4 covariances as 10 channels stacked on axis -2
([P, 10, F], index helper `S4`), means as [P, 4, F]: the particle axis
stays leading (uniform pytree ops) and the big F axis stays minor.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from phdslam_tpu.config import (
    DYNAMIC_MEASUREMENT,
    SlamConfig,
)
from phdslam_tpu.filter.state import Gaussian4DMixture
from phdslam_tpu.models.measurement import predict_measurement, range_class
from phdslam_tpu.ops.linalg import safe_log, wrap_angle

LOG_2PI = 1.8378770664093453

# symmetric 4x4 channel index: (i, j) i<=j -> 0..9
S4 = {}
_k = 0
for _i in range(4):
    for _j in range(_i, 4):
        S4[(_i, _j)] = _k
        _k += 1


def s4(c, i, j):
    """Read channel (i, j) of a [..., 10, F] symmetric-4x4 stack."""
    return c[..., S4[(min(i, j), max(i, j))], :]


def chol4_solve_sq(c, d):
    """||L^-1 d||^2 for a symmetric 4x4 channel stack c [..., 10, F] and
    vector channels d [..., 4, F] — the Mahalanobis quadratic form via a
    channelized Cholesky (mirrors the Eigen LLT of src/gm_reduce.cpp:30-37).
    """
    eps = 1e-12
    l00 = jnp.sqrt(jnp.maximum(s4(c, 0, 0), eps))
    l10 = s4(c, 0, 1) / l00
    l20 = s4(c, 0, 2) / l00
    l30 = s4(c, 0, 3) / l00
    l11 = jnp.sqrt(jnp.maximum(s4(c, 1, 1) - l10 * l10, eps))
    l21 = (s4(c, 1, 2) - l20 * l10) / l11
    l31 = (s4(c, 1, 3) - l30 * l10) / l11
    l22 = jnp.sqrt(jnp.maximum(s4(c, 2, 2) - l20 * l20 - l21 * l21, eps))
    l32 = (s4(c, 2, 3) - l30 * l20 - l31 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(
        s4(c, 3, 3) - l30 * l30 - l31 * l31 - l32 * l32, eps))
    d0, d1, d2, d3 = (d[..., k, :] for k in range(4))
    y0 = d0 / l00
    y1 = (d1 - l10 * y0) / l11
    y2 = (d2 - l20 * y0 - l21 * y1) / l22
    y3 = (d3 - l30 * y0 - l31 * y1 - l32 * y2) / l33
    return y0 * y0 + y1 * y1 + y2 * y2 + y3 * y3


class PreUpdate4(NamedTuple):
    r: jax.Array
    bearing: jax.Array
    pd: jax.Array
    rclass: jax.Array
    gain: jax.Array        # [P, 8, F] rows-major (i, a) -> 2*i + a
    cov_update: jax.Array  # [P, 10, F]
    si00: jax.Array
    si01: jax.Array
    si11: jax.Array
    log_det_s: jax.Array


def kalman_preupdate4(pose, gm: Gaussian4DMixture,
                      cfg: SlamConfig) -> PreUpdate4:
    """Channelized 4-D EKF pre-update (src/phdfilter.cu:397-521)."""
    c = gm.cov_channels            # [P, 10, F]
    mean_xy = jnp.stack([gm.mean_channels[..., 0, :],
                         gm.mean_channels[..., 1, :]], axis=-1)
    r, b, dx, dy, r2 = predict_measurement(pose[:, None, :], mean_xy)
    rc = range_class(r, b, cfg)
    rc = jnp.where(gm.valid, rc, 0)
    in_mask = rc == 1
    pd = jnp.where(in_mask, cfg.pd, 0.0).astype(gm.w.dtype)

    dx = jnp.where(in_mask, dx, 1.0)
    dy = jnp.where(in_mask, dy, 0.0)
    r2s = dx * dx + dy * dy
    rs = jnp.sqrt(r2s)
    j00 = dx / rs
    j01 = dy / rs
    j10 = -dy / r2s
    j11 = dx / r2s
    jrows = ((j00, j01), (j10, j11))

    var_r = cfg.stdRange ** 2
    var_b = cfg.stdBearing ** 2
    p00, p01, p11 = s4(c, 0, 0), s4(c, 0, 1), s4(c, 1, 1)
    a00 = j00 * (j00 * p00 + j01 * p01) + j01 * (j00 * p01 + j01 * p11)
    a01 = j10 * (j00 * p00 + j01 * p01) + j11 * (j00 * p01 + j01 * p11)
    a11 = j10 * (j10 * p00 + j11 * p01) + j11 * (j10 * p01 + j11 * p11)
    s00, s01, s11 = a00 + var_r, a01, a11 + var_b
    det_pos = jnp.maximum(p00 * p11 - p01 * p01, 0.0)
    det_s = jnp.maximum(det_pos / r2s + a00 * var_b + a11 * var_r
                        + var_r * var_b, var_r * var_b)
    si00, si01, si11 = s11 / det_s, -s01 / det_s, s00 / det_s
    si = ((si00, si01), (si01, si11))

    # K = P H^T J^T S^-1: T[i][a] = sum_b P[i, b] * J[a][b], b in {0, 1}
    t = [[s4(c, i, 0) * jrows[a][0] + s4(c, i, 1) * jrows[a][1]
          for a in range(2)] for i in range(4)]
    gain = [[t[i][0] * si[0][a] + t[i][1] * si[1][a]
             for a in range(2)] for i in range(4)]

    # L = I - K Jfull, Jfull = J H (2x4, nonzero cols 0,1):
    # L[i][0] = d(i,0) - (K[i][0] j00 + K[i][1] j10), similarly col 1;
    # cols 2,3 of L are identity.
    def delta(i, j):
        return 1.0 if i == j else 0.0

    lcol = [[delta(i, 0) - (gain[i][0] * j00 + gain[i][1] * j10),
             delta(i, 1) - (gain[i][0] * j01 + gain[i][1] * j11)]
            for i in range(4)]
    # Q = L P: q[i][j] = L[i][0] p0j + L[i][1] p1j + (i>=2 ? p_ij : 0)
    q = [[lcol[i][0] * s4(c, 0, j) + lcol[i][1] * s4(c, 1, j)
          + (s4(c, i, j) if i >= 2 else 0.0)
          for j in range(4)] for i in range(4)]
    # P' = Q L^T + K R K^T
    cov_up = []
    for i in range(4):
        for j in range(i, 4):
            val = (q[i][0] * lcol[j][0] + q[i][1] * lcol[j][1]
                   + (q[i][2] if j == 2 else 0.0)
                   + (q[i][3] if j == 3 else 0.0)
                   + gain[i][0] * gain[j][0] * var_r
                   + gain[i][1] * gain[j][1] * var_b)
            cov_up.append(val)
    gain_arr = jnp.stack([gain[i][a] for i in range(4) for a in range(2)],
                         axis=-2)                      # [P, 8, F]
    return PreUpdate4(
        r=r, bearing=b, pd=pd, rclass=rc, gain=gain_arr,
        cov_update=jnp.stack(cov_up, axis=-2),
        si00=si00, si01=si01, si11=si11, log_det_s=jnp.log(det_s))


def birth4_channels(pose, z_rb, cfg, vel=None):
    """4-D birth Gaussians (computeBirth 4-D, src/phdfilter.cu:244-299):
    position block from the inverse measurement, zero velocity mean,
    diag(covVxBirth, covVyBirth) velocity covariance.

    pose [P,>=3], z_rb gathered per candidate [P,K,2]-style channels.
    vel: optional (vx, vy, var_v) informed velocity init (broadcastable to
    the birth shape) from `informed_birth_velocity` — replaces the
    zero-mean prior per birth (cfg.birthVelocityInit extension).
    Returns mean channels [4][...], cov channels [10][...]."""
    rng = z_rb[..., 0]
    theta = pose[..., 2] + z_rb[..., 1]
    ct, st = jnp.cos(theta), jnp.sin(theta)
    bdx = rng * ct
    bdy = rng * st
    var_r = (cfg.stdRange * cfg.birthNoiseFactor) ** 2
    var_b = (cfg.stdBearing * cfg.birthNoiseFactor) ** 2
    z = jnp.zeros_like(bdx)
    if vel is None:
        vx = vy = z
        vvx = jnp.full_like(bdx, cfg.covVxBirth)
        vvy = jnp.full_like(bdx, cfg.covVyBirth)
    else:
        vx, vy, var_v = vel
        vx = jnp.broadcast_to(vx, bdx.shape)
        vy = jnp.broadcast_to(vy, bdx.shape)
        vvx = vvy = jnp.broadcast_to(var_v, bdx.shape)
    mean = [pose[..., 0] + bdx, pose[..., 1] + bdy, vx, vy]
    cov = [ct * ct * var_r + bdy * bdy * var_b,      # (0,0)
           ct * st * var_r - bdy * bdx * var_b,      # (0,1)
           z, z,                                      # (0,2) (0,3)
           st * st * var_r + bdx * bdx * var_b,      # (1,1)
           z, z,                                      # (1,2) (1,3)
           vvx,                                       # (2,2)
           z,                                         # (2,3)
           vvy]                                       # (3,3)
    return mean, cov


def informed_birth_velocity(pose, z_rb, z_valid, zw_prev, zp_valid, dt,
                            cfg: SlamConfig):
    """Two-detection velocity initialization for 4-D births
    (cfg.birthVelocityInit; rebuild extension, no reference
    counterpart — the reference births at zero velocity,
    src/phdfilter.cu:244-299).

    For each current measurement m, find the nearest previous-step
    measurement in the world frame (zw_prev [P, Mp, 2], converted at the
    pre-prediction pose) and form the two-point velocity observation
    v_obs = (p_m - p_prev)/dt with variance var_obs = 2*sigma_p^2/dt^2
    (per-axis isotropic bound sigma_p^2 = var_r + (r*std_b)^2). The birth
    velocity is the BAYESIAN FUSION of the zero-mean covVxBirth prior
    with that observation:

        gain   = covVxBirth / (covVxBirth + var_obs)
        v_init = gain * v_obs
        var_v  = gain * var_obs   (= posterior variance < covVxBirth)

    so in a noise regime where the two-point estimate is uninformative
    (var_obs >> prior, e.g. sigma_p ~ 1 m at dt = 1 s vs sub-m/s movers)
    the init automatically degrades toward the zero-velocity reference
    birth instead of injecting nearest-neighbor (often clutter) noise at
    full strength — the failure mode of the raw two-point init, measured:
    settled-pair under-2m fraction 0.25 raw vs 0.536 zero-init on the
    mixed MC envelope. Matching radius covers measurement noise plus the
    fastest admissible mover: 3*sigma_p + birthVelMax*dt.

    Returns (vx [P,M], vy [P,M], var_v [P,M]) — unmatched measurements get
    (0, 0, covVxBirth).
    """
    theta = pose[:, None, 2] + z_rb[None, :, 1]
    px = pose[:, None, 0] + z_rb[None, :, 0] * jnp.cos(theta)   # [P,M]
    py = pose[:, None, 1] + z_rb[None, :, 0] * jnp.sin(theta)
    dx = px[:, :, None] - zw_prev[:, None, :, 0]                # [P,M,Mp]
    dy = py[:, :, None] - zw_prev[:, None, :, 1]
    d2 = dx * dx + dy * dy
    d2 = jnp.where(zp_valid[None, None, :], d2, jnp.inf)
    j = jnp.argmin(d2, axis=-1)                                 # [P,M]
    dmin2 = jnp.min(d2, axis=-1)
    var_p = cfg.stdRange ** 2 + (z_rb[None, :, 0] * cfg.stdBearing) ** 2
    r_match = 3.0 * jnp.sqrt(var_p) + cfg.birthVelMax * dt
    # a zero/negative dt (duplicate timestamps) makes the two-point
    # velocity undefined: force unmatched (-> zero-velocity prior birth)
    # and guard the divisions so no Inf/NaN is ever materialized.
    dt_ok = dt > 0.0
    dt_safe = jnp.maximum(dt, 1e-6)
    matched = (dmin2 < r_match * r_match) & z_valid[None, :] \
        & jnp.any(zp_valid) & dt_ok
    take = lambda a: jnp.take_along_axis(
        a[:, None, :], j[:, :, None], axis=2)[..., 0]      # [P,Mp]->[P,M]
    var_obs = 2.0 * var_p / (dt_safe * dt_safe)
    gain = cfg.covVxBirth / (cfg.covVxBirth + var_obs)
    vx = jnp.where(matched, gain * (px - take(zw_prev[..., 0])) / dt_safe,
                   0.0)
    vy = jnp.where(matched, gain * (py - take(zw_prev[..., 1])) / dt_safe,
                   0.0)
    var_v = jnp.where(matched,
                      jnp.maximum(gain * var_obs, 0.1 * cfg.covVxBirth),
                      cfg.covVxBirth)
    return vx, vy, var_v


def prev_measurement_world(pose, z_prev_rb, z_prev_valid):
    """World-frame positions of the previous step's measurements at the
    PRE-prediction pose (i.e. pose_{t-1}) — the anchor points for
    `informed_birth_velocity`. pose [P,>=3]; returns [P, Mp, 2]."""
    theta = pose[:, None, 2] + z_prev_rb[None, :, 1]
    x = pose[:, None, 0] + z_prev_rb[None, :, 0] * jnp.cos(theta)
    y = pose[:, None, 1] + z_prev_rb[None, :, 0] * jnp.sin(theta)
    return jnp.stack([x, y], axis=-1)


def greedy_merge4(w, mean, cov, min_separation, max_out: int):
    """Channelized 4-D greedy merge. w [P,K]; mean [P,4,K]; cov [P,10,K].
    Returns (w_out [P,max_out], mean_out [P,4,max_out],
             cov_out [P,10,max_out])."""
    P, K = w.shape
    dtype = w.dtype
    col = jnp.arange(K)

    def body(carry):
        i, w_rem, ow, om, oc = carry
        pick = jnp.argmax(w_rem, axis=1)
        rm = jnp.take_along_axis(mean, pick[:, None, None], axis=2)
        rc = jnp.take_along_axis(cov, pick[:, None, None], axis=2)
        avg = 0.5 * (rc + cov)                 # [P, 10, K]
        d = rm - mean                          # [P, 4, K]
        dist = chol4_solve_sq(avg, d)
        sel = (dist < min_separation) & (w_rem > 0)
        sel = sel | (col[None, :] == pick[:, None])
        active = jnp.any(w_rem > 0, axis=1)
        sel = sel & active[:, None]
        sw = jnp.where(sel, w_rem, 0.0)
        wsum = jnp.sum(sw, axis=1)
        inv = jnp.where(wsum > 0, 1.0 / jnp.maximum(wsum, 1e-38), 0.0)
        mu = jnp.sum(sw[:, None, :] * mean, axis=2) * inv[:, None]  # [P,4]
        dd = mu[:, :, None] - mean                                   # [P,4,K]
        newc = []
        for a in range(4):
            for b_ in range(a, 4):
                nc = jnp.sum(
                    sw * (s4(cov, a, b_) + dd[:, a] * dd[:, b_]),
                    axis=1) * inv
                if a == b_:
                    # exhausted rows keep the identity-cov empty convention
                    nc = jnp.where(wsum > 0, nc, 1.0)
                newc.append(nc)
        newc = jnp.stack(newc, axis=1)                               # [P,10]
        ow = jax.lax.dynamic_update_index_in_dim(ow, wsum, i, 1)
        om = jax.lax.dynamic_update_index_in_dim(om, mu, i, 2)
        oc = jax.lax.dynamic_update_index_in_dim(oc, newc, i, 2)
        w_rem = jnp.where(sel, 0.0, w_rem)
        return i + 1, w_rem, ow, om, oc

    def cond(carry):
        i, w_rem, *_ = carry
        return (i < max_out) & jnp.any(w_rem > 0)

    eye_c = jnp.stack([jnp.ones((P, max_out), dtype) if i == j
                       else jnp.zeros((P, max_out), dtype)
                       for i in range(4) for j in range(i, 4)], axis=1)
    init = (jnp.array(0, jnp.int32), w,
            jnp.zeros((P, max_out), dtype),
            jnp.zeros((P, 4, max_out), dtype), eye_c)
    _, _, ow, om, oc = jax.lax.while_loop(cond, body, init)
    return ow, om, oc


def cv_predict4(gm: Gaussian4DMixture, cfg: SlamConfig, dt,
                w_scale=None) -> Gaussian4DMixture:
    """Channelized constant-velocity prediction of the dynamic map
    (predictMapKernelMixed / ConstantVelocityMotionModel,
    device_math.cuh:608-658): mean' = F mean, cov' = F cov F^T + Q with the
    white-acceleration Q; optional weight scaling (survival * jump-Markov)."""
    m = gm.mean_channels
    c = gm.cov_channels
    vx_var = cfg.stdAxMap ** 2
    vy_var = cfg.stdAyMap ** 2
    d2, d3, d4 = dt * dt, dt ** 3 / 2.0, dt ** 4 / 4.0
    new_m = jnp.stack([
        m[..., 0, :] + dt * m[..., 2, :],
        m[..., 1, :] + dt * m[..., 3, :],
        m[..., 2, :],
        m[..., 3, :],
    ], axis=-2)
    p = lambda i, j: s4(c, i, j)
    new_c = jnp.stack([
        p(0, 0) + 2 * dt * p(0, 2) + d2 * p(2, 2) + d4 * vx_var,   # 00
        p(0, 1) + dt * p(0, 3) + dt * p(1, 2) + d2 * p(2, 3),      # 01
        p(0, 2) + dt * p(2, 2) + d3 * vx_var,                      # 02
        p(0, 3) + dt * p(2, 3),                                    # 03
        p(1, 1) + 2 * dt * p(1, 3) + d2 * p(3, 3) + d4 * vy_var,   # 11
        p(1, 2) + dt * p(2, 3),                                    # 12
        p(1, 3) + dt * p(3, 3) + d3 * vy_var,                      # 13
        p(2, 2) + d2 * vx_var,                                     # 22
        p(2, 3),                                                   # 23
        p(3, 3) + d2 * vy_var,                                     # 33
    ], axis=-2)
    w = gm.w if w_scale is None else gm.w * w_scale
    return Gaussian4DMixture(w=w, mean_channels=new_m, cov_channels=new_c)


def jump_markov_scales(gm: Gaussian4DMixture, cfg: SlamConfig):
    """Survival and jump-Markov weight factors (predictMapKernelMixed,
    src/phdfilter.cu:923-954). Returns (dynamic_scale, jump_weight) where
    jump_weight = (1-p_jmm)*w are the 2-D 'jump' copies (the reference
    computes but never re-inserts them, src/phdfilter.cu:1015-1020)."""
    vx = gm.mean_channels[..., 2, :]
    vy = gm.mean_channels[..., 3, :]
    v_mag = jnp.sqrt(vx * vx + vy * vy)
    sigmoid_v = 1.0 / (1.0 + jnp.exp(cfg.beta * (cfg.tau - v_mag)))
    if cfg.featureModel == 1:  # DYNAMIC
        p_jmm = jnp.ones_like(v_mag)
        ps = 1.0 - (1.0 - cfg.ps) / (1.0 + jnp.exp(-cfg.beta
                                                   * (v_mag - cfg.tau)))
    else:  # MIXED
        p_jmm = sigmoid_v
        ps = jnp.full_like(v_mag, cfg.ps)
    return p_jmm * ps, (1.0 - p_jmm) * gm.w


def phd_update_mixed(pose, gm2, gm4, z_rb, z_label, z_valid,
                     cfg: SlamConfig, birth_vel=None):
    """MIXED-model PHD update (phdUpdateKernelMixed,
    src/phdfilter.cu:2323-2635): one normalizer per measurement over the
    static AND dynamic detection terms; static and dynamic births both
    appended (two birthWeight terms in the normalizer when measurements are
    unlabeled); separate prune/merge per map type.

    birth_vel: optional (vx [P,M], vy [P,M], var_v [P,M]) informed 4-D
    birth velocity from `informed_birth_velocity` (cfg.birthVelocityInit).

    Returns (gm2_out, gm4_out, log_weight_delta [P]).
    """
    from phdslam_tpu.filter.state import Gaussian2DMixture
    from phdslam_tpu.filter.update import (
        detection_log_weights,
        kalman_preupdate,
    )
    from phdslam_tpu.ops.gm import greedy_merge_channels
    from phdslam_tpu.config import STATIC_MEASUREMENT

    P, F2 = gm2.w.shape
    F4 = gm4.w.shape[-1]
    M = z_rb.shape[0]
    dtype = gm2.w.dtype

    pre2 = kalman_preupdate(pose, gm2, cfg)
    from phdslam_tpu.kernels import kernel_mode
    use_pallas, interp = kernel_mode(cfg)
    if use_pallas:
        # fused raw-mode select for the static half: detection masses +
        # unnormalized top-k1 candidates without materializing [P, M, F2]
        k1s = min(cfg.selectTopK or (4 if cfg.mergeMode == 1 else 8), F2)
        nv2 = jnp.max(jnp.where(z_valid, jnp.arange(z_rb.shape[0]) + 1, 0))
        from phdslam_tpu.kernels.preupdate_pallas import fused_update_select
        (sum_exp2, e_sel2, mx_sel2, my_sel2, u00_sel2, u01_sel2,
         u11_sel2, _lpw, _compat) = fused_update_select(
            z_rb, pre2, gm2, cfg, k1=k1s, raw=True, n_valid=nv2,
            with_compat=False, with_lpw=False, interpret=interp)
        if cfg.labeledMeasurements:
            m_ok2 = z_valid & (z_label == STATIC_MEASUREMENT)
        else:
            m_ok2 = z_valid
        sum_exp2 = jnp.where(m_ok2[None, :], sum_exp2, 0.0)
        e_sel2 = jnp.where(m_ok2[None, :, None], e_sel2, 0.0)
    else:
        lw2 = detection_log_weights(pre2, gm2, z_rb, z_label, z_valid, cfg)
        sum_exp2 = jnp.sum(jnp.exp(lw2), axis=-1)

    # the dynamic (4-D) half always takes the XLA path
    pre4 = kalman_preupdate4(pose, gm4, cfg)
    innov_r = z_rb[None, :, None, 0] - pre4.r[:, None, :]
    innov_b = wrap_angle(
        z_rb[None, :, None, 1] - pre4.bearing[:, None, :])
    dist4 = (innov_r ** 2 * pre4.si00[:, None, :]
             + 2 * innov_r * innov_b * pre4.si01[:, None, :]
             + innov_b ** 2 * pre4.si11[:, None, :])
    dist4 = jnp.maximum(dist4, 0.0)   # see detection_log_weights
    lw4 = (safe_log(pre4.pd)[:, None, :] + safe_log(gm4.w)[:, None, :]
           - 0.5 * dist4 - LOG_2PI - 0.5 * pre4.log_det_s[:, None, :])
    ok4 = (pre4.rclass == 1)[:, None, :] & z_valid[None, :, None]
    if cfg.labeledMeasurements:
        ok4 = ok4 & (z_label[None, :, None] == DYNAMIC_MEASUREMENT)
    lw4 = jnp.where(ok4, lw4, -jnp.inf)
    sum_exp4 = jnp.sum(jnp.exp(lw4), axis=-1)

    # --- joint per-measurement normalizer (src/phdfilter.cu:2476-2505) ---
    # birthWeightDynamic < 0 -> symmetric births (reference semantics);
    # >= 0 -> the dynamic map births at its own weight (extension, see
    # config.py) and the normalizer carries the per-map terms
    sum_exp = sum_exp2 + sum_exp4
    bw_s = cfg.birthWeight
    bw_d = cfg.birthWeightDynamic if cfg.birthWeightDynamic >= 0.0 \
        else cfg.birthWeight
    if cfg.labeledMeasurements:
        # one birth term per measurement: the labeled map's
        birth_terms = jnp.where(z_label == DYNAMIC_MEASUREMENT,
                                bw_d, bw_s)[None, :]
    else:
        birth_terms = bw_s + bw_d
    normalizer = sum_exp + cfg.clutterDensity + birth_terms
    log_norm = safe_log(normalizer)
    mvalid = z_valid.astype(dtype)
    n_measure = jnp.sum(mvalid)

    w_nd2 = jnp.where(pre2.rclass == 1, gm2.w * (1.0 - pre2.pd), 0.0)
    w_nd4 = jnp.where(pre4.rclass == 1, gm4.w * (1.0 - pre4.pd), 0.0)
    if not use_pallas:
        w_det2 = jnp.exp(lw2 - log_norm[..., None])
    w_det4 = jnp.exp(lw4 - log_norm[..., None])
    if cfg.labeledMeasurements:
        b2_ok = (z_label == STATIC_MEASUREMENT)[None, :]
        b4_ok = (z_label == DYNAMIC_MEASUREMENT)[None, :]
    else:
        b2_ok = b4_ok = jnp.ones((1, M), bool)
    w_b2 = jnp.where(b2_ok & z_valid[None, :],
                     jnp.asarray(bw_s, dtype) / normalizer, 0.0)
    w_b4 = jnp.where(b4_ok & z_valid[None, :],
                     jnp.asarray(bw_d, dtype) / normalizer, 0.0)

    # --- particle weights ---
    sum_log_norm = jnp.sum(log_norm * mvalid[None, :], axis=-1)
    if cfg.particleWeighting == 0:
        # mixed kernel: cardinality = sum pd*w over both maps only
        # (src/phdfilter.cu:2410-2447 — births contribute 0 here)
        card_pred = (jnp.sum(pre2.pd * gm2.w, axis=-1)
                     + jnp.sum(pre4.pd * gm4.w, axis=-1))
        dw = sum_log_norm - card_pred
    else:
        cn_pred = (jnp.sum(jnp.where(pre2.rclass == 1, gm2.w, 0.0), -1)
                   + jnp.sum(jnp.where(pre4.rclass == 1, gm4.w, 0.0), -1)
                   + n_measure * cfg.birthWeight)
        # total detection mass per measurement in closed form
        det_mass = (sum_exp2 + sum_exp4) / normalizer
        cn_up = (jnp.sum(w_nd2, -1) + jnp.sum(w_nd4, -1)
                 + jnp.sum(det_mass * mvalid[None, :], -1)
                 + jnp.sum(w_b2 * mvalid[None, :], -1)
                 + jnp.sum(w_b4 * mvalid[None, :], -1))
        dw = (n_measure * cfg.clutterDensity + cn_up - cn_pred
              - cfg.clutterRate)

    # --- static map: prune/pool/merge (same machinery as the pure-static
    # path, with the mixed normalizer already applied) ---
    if use_pallas:
        sel = (e_sel2 * (1.0 / normalizer)[:, :, None], mx_sel2, my_sel2,
               u00_sel2, u01_sel2, u11_sel2)
        gm2_out = _pool_merge_static_sel(gm2, pre2, w_nd2, sel, w_b2,
                                         z_rb, pose, cfg)
    else:
        gm2_out = _pool_merge_static(gm2, pre2, w_nd2, w_det2, w_b2, z_rb,
                                     pose, cfg)
    gm4_out = _pool_merge_dynamic(gm4, pre4, w_nd4, w_det4, w_b4,
                                  z_rb, pose, cfg, birth_vel=birth_vel)
    return gm2_out, gm4_out, dw


def _pool_merge_static(gm2, pre2, w_nd, w_det, w_birth, z_rb, pose, cfg):
    """Static-map candidate pool + merge with externally supplied component
    weights (shared by the mixed path): XLA top-k selection along F, then
    the sectioned merge."""
    P, F = gm2.w.shape
    M = z_rb.shape[0]
    minw = cfg.minFeatureWeight
    from phdslam_tpu.filter.update import gather_selected

    k1 = min(cfg.selectTopK or (4 if cfg.mergeMode == 1 else 8), F)
    w_det_p = jnp.where(w_det >= minw, w_det, 0.0)
    w_sel, f_sel = jax.lax.top_k(w_det_p, k1)                   # [P,M,k1]
    (mx_sel, my_sel, u00_sel, u01_sel, u11_sel,
     _lpw) = gather_selected(pre2, gm2, z_rb, f_sel, with_lpw=False)
    sel = (w_sel, mx_sel, my_sel, u00_sel, u01_sel, u11_sel)
    return _pool_merge_static_sel(gm2, pre2, w_nd, sel, w_birth, z_rb,
                                  pose, cfg)


def _pool_merge_static_sel(gm2, pre2, w_nd, sel, w_birth, z_rb, pose, cfg):
    """Sectioned, gather-free static merge from preselected detection
    channels (filter/update.py layout): [originals F | detections M*k1 |
    births M]; the merge output is directly the new map. Near/out-of-range
    features ride the originals section with their prior weights."""
    from phdslam_tpu.filter.state import Gaussian2DMixture
    from phdslam_tpu.kernels import kernel_mode
    from phdslam_tpu.ops.gm import greedy_merge_channels

    use_kernel, interp = kernel_mode(cfg)
    w_sel, mx_sel, my_sel, u00_sel, u01_sel, u11_sel = sel
    P, F = gm2.w.shape
    M = z_rb.shape[0]
    k1 = w_sel.shape[-1]
    minw = cfg.minFeatureWeight
    w_nd_p = jnp.where(w_nd >= minw, w_nd, 0.0)
    w_b_p = jnp.where(w_birth >= minw, w_birth, 0.0)
    w_sec1 = jnp.where(pre2.rclass == 1, w_nd_p, gm2.w)
    w_sel = jnp.where(w_sel >= minw, w_sel, 0.0)

    theta_b = pose[:, None, 2] + z_rb[None, :, 1]
    ct, st = jnp.cos(theta_b), jnp.sin(theta_b)
    bdx = z_rb[None, :, 0] * ct
    bdy = z_rb[None, :, 0] * st
    var_rb = (cfg.stdRange * cfg.birthNoiseFactor) ** 2
    var_bb = (cfg.stdBearing * cfg.birthNoiseFactor) ** 2

    flat = lambda a: a.reshape(P, M * k1)
    cat = lambda a, b, c: jnp.concatenate([a, b, c], axis=-1)
    cand_w = cat(w_sec1, flat(w_sel), w_b_p)
    if cfg.mergeMode == 1:
        from phdslam_tpu.ops.gm import fast_prune_renormalize
        cand_w = fast_prune_renormalize(cand_w, cfg.mergeMinWeight)
    mw, mmx, mmy, m00, m01, m11 = greedy_merge_channels(
        cand_w,
        cat(gm2.mx, flat(mx_sel), pose[:, None, 0] + bdx),
        cat(gm2.my, flat(my_sel), pose[:, None, 1] + bdy),
        cat(gm2.c00, flat(u00_sel),
            ct * ct * var_rb + bdy * bdy * var_bb),
        cat(gm2.c01, flat(u01_sel),
            ct * st * var_rb - bdy * bdx * var_bb),
        cat(gm2.c11, flat(u11_sel),
            st * st * var_rb + bdx * bdx * var_bb),
        cfg.minSeparation, F, metric=cfg.distanceMetric,
        use_kernel=use_kernel, interpret=interp)
    return Gaussian2DMixture(w=mw, mx=mmx, my=mmy, c00=m00, c01=m01,
                             c11=m11)


def gather_selected4(pre4, gm4, z_rb, f_sel):
    """4-D analogue of filter.update.gather_selected: reconstruct the
    detection means (via the measurement-independent gains) and updated
    covariances from picked feature indices f_sel [P, M, k1]."""
    P, M, k1 = f_sel.shape
    take_sel = lambda a: jnp.take_along_axis(
        a[:, None, :], jnp.broadcast_to(f_sel, (P, M, k1)), axis=2)
    take_selc = lambda a: jnp.take_along_axis(
        a[:, :, None, :],
        jnp.broadcast_to(f_sel[:, None], (P, a.shape[1], M, k1)), axis=3)
    ir = z_rb[None, :, None, 0] - take_sel(pre4.r)
    ib = wrap_angle(z_rb[None, :, None, 1] - take_sel(pre4.bearing))
    gk = take_selc(pre4.gain)                                   # [P,8,M,k1]
    mean_f = take_selc(gm4.mean_channels)                       # [P,4,M,k1]
    mean_det = jnp.stack(
        [mean_f[:, i] + gk[:, 2 * i] * ir + gk[:, 2 * i + 1] * ib
         for i in range(4)], axis=1)
    cov_det = take_selc(pre4.cov_update)                        # [P,10,M,k1]
    return mean_det, cov_det


def _pool_merge_dynamic(gm4, pre4, w_nd, w_det, w_birth, z_rb, pose, cfg,
                        birth_vel=None):
    """Dynamic-map candidate pool + 4-D merge, sectioned layout
    [non-detections F | detections M*k1 | births M]. NOTE: the reference
    kills out-of-range dynamic features entirely after the update ('hack to
    kill off out-of-range dynamic features', src/phdfilter.cu:3713-3719) —
    only in-range non-detection terms enter the originals section. With
    cfg.keepOobDynamic, out-of-FOV features pass through like the static
    map's instead (see the config-field note)."""
    P, F = gm4.w.shape
    M = z_rb.shape[0]
    minw = cfg.minFeatureWeight
    w_sec1 = jnp.where(w_nd >= minw, w_nd, 0.0)
    if cfg.keepOobDynamic:
        w_sec1 = jnp.where(pre4.rclass == 1, w_sec1, gm4.w)
    w_b_p = jnp.where(w_birth >= minw, w_birth, 0.0)

    k1 = min(cfg.selectTopK or (4 if cfg.mergeMode == 1 else 8), F)
    w_det_p = jnp.where(w_det >= minw, w_det, 0.0)
    w_sel, f_sel = jax.lax.top_k(w_det_p, k1)                   # [P,M,k1]
    mean_det, cov_det = gather_selected4(pre4, gm4, z_rb, f_sel)

    bm, bc = birth4_channels(pose[:, None, :], z_rb[None, :, :], cfg,
                             vel=birth_vel)
    mean_b = jnp.stack(bm, axis=1)                              # [P,4,M]
    cov_b = jnp.stack(bc, axis=1)                               # [P,10,M]

    flat = lambda a: a.reshape(P, M * k1)
    flatc = lambda a: a.reshape(P, a.shape[1], M * k1)
    cand_w = jnp.concatenate([w_sec1, flat(w_sel), w_b_p], axis=-1)
    if cfg.mergeMode == 1:
        from phdslam_tpu.ops.gm import fast_prune_renormalize
        cand_w = fast_prune_renormalize(cand_w, cfg.mergeMinWeight)
    cand_mean = jnp.concatenate(
        [gm4.mean_channels, flatc(mean_det), mean_b], axis=-1)
    cand_cov = jnp.concatenate(
        [gm4.cov_channels, flatc(cov_det), cov_b], axis=-1)
    min_sep = cfg.minSeparationDynamic \
        if cfg.minSeparationDynamic > 0 else cfg.minSeparation
    ow, om, oc = greedy_merge4(cand_w, cand_mean, cand_cov, min_sep, F)
    return Gaussian4DMixture(w=ow, mean_channels=om, cov_channels=oc)

