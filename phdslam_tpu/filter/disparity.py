"""Monocular SC-PHD SLAM in disparity space (the reference's second
pipeline, run_type=disparity).

Rebuild of disparityPredict/disparityUpdate (src/phdfilter.cu:4520-5216):
each particle carries a 6-DOF camera state and a PHD map whose features are
*particle clouds* of `particlesPerFeature` 3-D world points plus a mixture
weight. Per step:

  1. 6-DOF constant-velocity camera prediction (camera-frame translation,
     src/phdfilter.cu:4520-4570)
  2. world -> disparity (u, v, d) transform of every feature particle
     (thrust zip functor, :4644-4664)
  3. fit a 3-D Gaussian to each feature's disparity-space cloud
     (fitGaussiansKernel, :4133-4248 — sample mean + covariance /(n-1))
  4. in-image gating on the fitted mean (is_inrange functor, :4100-4126)
  5. births at (u, v, disparityBirth) with diag(stdU^2, stdV^2, stdDBirth^2)
     (:4846-4871)
  6. EKF pre-update in disparity space: H = [I2 | 0] picks (u, v)
     (preUpdateDisparityKernel, :4306-4373)
  7. the shared PHD update (per-measurement normalizers, particle weights)
     and greedy merge (:4929-4983)
  8. sample the merged Gaussians back to particle clouds
     (sampleGaussiansKernel, :4250-4304) and transform disparity -> world
     (:5133-5151)

Fixed-shape state: [P, F] feature slots, each [Npp] particles; 3-D Gaussian
channels (3 mean + 6 covariance scalars) throughout — same tiling rationale
as the 2-D path.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from phdslam_tpu.utils import pytree_dataclass

from phdslam_tpu.config import SlamConfig
from phdslam_tpu.models.camera import (
    camera_cv_predict,
    disparity_to_world,
    world_to_disparity,
)
from phdslam_tpu.ops.gm import greedy_merge_channels3
from phdslam_tpu.ops.linalg import safe_log

LOG_2PI = 1.8378770664093453


@pytree_dataclass
class DisparityState:
    """Per-particle camera + particle-cloud PHD map
    (DisparitySLAM, src/slamtypes.h:401-423)."""

    pose: jax.Array          # [P, 12] 6-DOF pose + velocities
    log_weights: jax.Array   # [P]
    w: jax.Array             # [P, F] feature mixture weights (0 = empty)
    px: jax.Array            # [P, F, Npp] world-frame particle clouds
    py: jax.Array
    pz: jax.Array
    resample_idx: jax.Array  # [P]

    @classmethod
    def create(cls, cfg: SlamConfig, max_features: int = None,
               dtype=jnp.float32) -> "DisparityState":
        n = cfg.n_particles
        f = max_features or cfg.maxFeatures
        npp = cfg.particlesPerFeature
        pose0 = jnp.array(
            [cfg.x0, cfg.y0, cfg.z0, cfg.roll0, cfg.pitch0, cfg.yaw0,
             cfg.vx0, cfg.vy0, cfg.vz0, cfg.vroll0, cfg.vpitch0, cfg.vyaw0],
            dtype)
        return cls(
            pose=jnp.broadcast_to(pose0, (n, 12)).copy(),
            log_weights=jnp.full((n,), -jnp.log(float(n)), dtype),
            w=jnp.zeros((n, f), dtype),
            px=jnp.zeros((n, f, npp), dtype),
            py=jnp.zeros((n, f, npp), dtype),
            pz=jnp.zeros((n, f, npp), dtype),
            resample_idx=jnp.arange(n, dtype=jnp.int32),
        )


def fit_gaussians(u, v, d):
    """Sample mean + covariance of each feature's disparity cloud
    (fitGaussiansKernel, src/phdfilter.cu:4133-4248; /(n-1) normalization).

    u/v/d [..., Npp]. Returns 3 mean + 6 cov channels [...]."""
    npp = u.shape[-1]
    mu_u = jnp.mean(u, axis=-1)
    mu_v = jnp.mean(v, axis=-1)
    mu_d = jnp.mean(d, axis=-1)
    du = u - mu_u[..., None]
    dv = v - mu_v[..., None]
    dd = d - mu_d[..., None]
    den = 1.0 / (npp - 1)
    return (mu_u, mu_v, mu_d,
            jnp.sum(du * du, -1) * den, jnp.sum(du * dv, -1) * den,
            jnp.sum(du * dd, -1) * den, jnp.sum(dv * dv, -1) * den,
            jnp.sum(dv * dd, -1) * den, jnp.sum(dd * dd, -1) * den)


def sample_gaussians(key, m0, m1, m2, c00, c01, c02, c11, c12, c22, npp):
    """Draw npp samples from each channelized 3-D Gaussian via closed-form
    Cholesky (sampleGaussiansKernel, src/phdfilter.cu:4250-4304).
    Channels [...]; returns (u, v, d) each [..., npp]."""
    eps = 1e-9
    l11 = jnp.sqrt(jnp.maximum(c00, eps))
    l21 = c01 / l11
    l22 = jnp.sqrt(jnp.maximum(c11 - l21 * l21, eps))
    l31 = c02 / l11
    l32 = (c12 - l31 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(c22 - l31 * l31 - l32 * l32, eps))
    x = jax.random.normal(key, m0.shape + (npp, 3), m0.dtype)
    u = m0[..., None] + x[..., 0] * l11[..., None]
    v = m1[..., None] + (x[..., 0] * l21[..., None]
                         + x[..., 1] * l22[..., None])
    d = m2[..., None] + (x[..., 0] * l31[..., None]
                         + x[..., 1] * l32[..., None]
                         + x[..., 2] * l33[..., None])
    return u, v, d


class DispAux(NamedTuple):
    expected_pose: jax.Array
    neff: jax.Array
    n_measure: jax.Array


@partial(jax.jit, static_argnames=("cfg", "pmesh"))
def disparity_step(state: DisparityState, key, z_uv, z_valid, dt,
                   do_predict, cfg: SlamConfig, pmesh=None):
    """One SC-PHD step. z_uv [M, 2] image measurements + validity mask.

    `pmesh` (optional single-axis particle Mesh): runs the 3-D greedy merge
    under shard_map, one merge per shard (see filter.step._pshard);
    numerics identical."""
    P, F, Npp = state.px.shape
    M = z_uv.shape[0]
    dtype = state.w.dtype
    k_pred, k_sample, k_res = jax.random.split(key, 3)

    # clutter density over the image area (src/main.cpp:1342-1344)
    clutter_density = cfg.clutterRate / (cfg.imageWidth * cfg.imageHeight)

    # ---- 1. camera prediction ----
    def do_pred(pose):
        noise = jax.random.normal(k_pred, (P, 6), dtype) * jnp.array(
            [cfg.ax, cfg.ay, cfg.az, cfg.aroll, cfg.apitch, cfg.ayaw],
            dtype)
        return camera_cv_predict(pose, noise, cfg, dt)

    pose = jax.lax.cond(do_predict, do_pred, lambda p: p, state.pose)

    # ---- 2. world -> disparity of all clouds ----
    cam = pose[:, None, None, :]      # broadcast over [F, Npp]
    u, v, d, fov = world_to_disparity(state.px, state.py, state.pz, cam, cfg)

    # ---- 3. fit 3-D Gaussians ----
    m0, m1, m2, c00, c01, c02, c11, c12, c22 = fit_gaussians(u, v, d)

    # ---- 4. in-image gating on fitted means ----
    in_fov = ((m0 > 0) & (m0 <= cfg.imageWidth)
              & (m1 >= 0) & (m1 <= cfg.imageHeight) & (m2 >= 0)
              & (state.w > 0))
    pd = jnp.where(in_fov, cfg.pd, 0.0).astype(dtype)

    # sanitize channels of empty/out slots so no NaNs leak through masking
    c00 = jnp.where(in_fov, c00, 1.0)
    c11 = jnp.where(in_fov, c11, 1.0)
    c22 = jnp.where(in_fov, c22, 1.0)
    c01 = jnp.where(in_fov, c01, 0.0)
    c02 = jnp.where(in_fov, c02, 0.0)
    c12 = jnp.where(in_fov, c12, 0.0)

    # ---- 6. EKF pre-update (H picks u, v) ----
    var_u = cfg.stdU ** 2
    var_v = cfg.stdV ** 2
    s00 = c00 + var_u
    s01 = c01
    s11 = c11 + var_v
    det_s = jnp.maximum(s00 * s11 - s01 * s01, var_u * var_v * 1e-6)
    si00 = s11 / det_s
    si01 = -s01 / det_s
    si11 = s00 / det_s
    # K = P H^T S^-1: rows of P @ [I2|0]^T are the first two cov columns
    k00 = c00 * si00 + c01 * si01
    k01 = c00 * si01 + c01 * si11
    k10 = c01 * si00 + c11 * si01
    k11 = c01 * si01 + c11 * si11
    k20 = c02 * si00 + c12 * si01
    k21 = c02 * si01 + c12 * si11
    # Joseph form P' = (I-KH) P (I-KH)^T + K R K^T, H = [I2|0]
    l00 = 1.0 - k00
    l01 = -k01
    l10 = -k10
    l11_ = 1.0 - k11
    q00 = l00 * c00 + l01 * c01
    q01 = l00 * c01 + l01 * c11
    q02 = l00 * c02 + l01 * c12
    q10 = l10 * c00 + l11_ * c01
    q11 = l10 * c01 + l11_ * c11
    q12 = l10 * c02 + l11_ * c12
    u00 = q00 * l00 + q01 * l01 + k00 * k00 * var_u + k01 * k01 * var_v
    u01 = q00 * l10 + q01 * l11_ + k00 * k10 * var_u + k01 * k11 * var_v
    u02 = (-k20) * q00 + (-k21) * q01 + q02 \
        + k00 * k20 * var_u + k01 * k21 * var_v
    u11 = q10 * l10 + q11 * l11_ + k10 * k10 * var_u + k11 * k11 * var_v
    u12 = (-k20) * q10 + (-k21) * q11 + q12 \
        + k10 * k20 * var_u + k11 * k21 * var_v
    u22 = (-k20) * (c02 * l00 + c12 * l01) \
        + (-k21) * (c02 * l10 + c12 * l11_) \
        + (c22 - k20 * c02 - k21 * c12) \
        + k20 * k20 * var_u + k21 * k21 * var_v

    # detection log-weights [P, M, F]
    iu = z_uv[None, :, None, 0] - m0[:, None, :]
    iv = z_uv[None, :, None, 1] - m1[:, None, :]
    dist = jnp.maximum(
        iu * iu * si00[:, None, :] + 2 * iu * iv * si01[:, None, :]
        + iv * iv * si11[:, None, :], 0.0)  # see detection_log_weights
    lw = (safe_log(pd)[:, None, :] + safe_log(state.w)[:, None, :]
          - 0.5 * dist - LOG_2PI - 0.5 * jnp.log(det_s)[:, None, :])
    ok = in_fov[:, None, :] & z_valid[None, :, None]
    lw = jnp.where(ok, lw, -jnp.inf)

    # per-measurement normalizers + particle weights (shared update kernel)
    sum_exp = jnp.sum(jnp.exp(lw), axis=-1)                     # [P, M]
    normalizer = sum_exp + clutter_density + cfg.birthWeight
    log_norm = safe_log(normalizer)
    mvalid = z_valid.astype(dtype)
    n_measure = jnp.sum(mvalid)
    w_nd = jnp.where(in_fov, state.w * (1.0 - pd), 0.0)
    w_det = jnp.exp(lw - log_norm[..., None])
    w_birth = jnp.where(z_valid[None, :],
                        cfg.birthWeight / normalizer, 0.0)

    if cfg.particleWeighting == 0:
        card_pred = jnp.sum(pd * state.w, axis=-1) \
            + n_measure * cfg.birthWeight
        dw = jnp.sum(log_norm * mvalid[None, :], axis=-1) - card_pred
    else:
        cn_pred = jnp.sum(jnp.where(in_fov, state.w, 0.0), axis=-1)
        cn_up = (jnp.sum(w_nd, -1)
                 + jnp.sum(w_det * mvalid[None, :, None], (-2, -1))
                 + jnp.sum(w_birth * mvalid[None, :], -1))
        dw = (n_measure * clutter_density + cn_up - cn_pred
              - cfg.clutterRate)

    # ---- prune + pool + merge (3-D channels) ----
    minw = cfg.minFeatureWeight
    w_nd_p = jnp.where(w_nd >= minw, w_nd, 0.0)
    w_det_p = jnp.where(w_det >= minw, w_det, 0.0)
    w_birth_p = jnp.where(w_birth >= minw, w_birth, 0.0)

    # Sectioned, gather-free merge candidates (same layout as the static
    # path, filter/update.py): [non-detections F | per-measurement top-k1
    # detections M*k1 | births M]; no pool-wide top-k, no row gathers. The
    # merge output (cap F) is the in-FOV content; out-of-FOV clouds union in
    # afterwards (they keep their particle clouds, so they cannot ride the
    # merge).
    k1 = min(8, F)
    w_sel, f_sel = jax.lax.top_k(w_det_p, k1)                   # [P,M,k1]
    take_sel = lambda a: jnp.take_along_axis(
        a[:, None, :], jnp.broadcast_to(f_sel, (P, M, k1)), axis=2)
    iu_k = z_uv[None, :, None, 0] - take_sel(m0)
    iv_k = z_uv[None, :, None, 1] - take_sel(m1)
    det_m0 = take_sel(m0) + take_sel(k00) * iu_k + take_sel(k01) * iv_k
    det_m1 = take_sel(m1) + take_sel(k10) * iu_k + take_sel(k11) * iv_k
    det_m2 = take_sel(m2) + take_sel(k20) * iu_k + take_sel(k21) * iv_k

    zu_b = z_uv[None, :, 0] * jnp.ones((P, 1), dtype)
    zv_b = z_uv[None, :, 1] * jnp.ones((P, 1), dtype)
    flat = lambda a: a.reshape(P, M * k1)
    cat3 = lambda a, b, c: jnp.concatenate([a, b, c], axis=-1)
    cand_w = cat3(w_nd_p, flat(jnp.where(w_sel >= minw, w_sel, 0.0)),
                  w_birth_p)
    cand = dict(
        m0=cat3(m0, flat(det_m0), zu_b),
        m1=cat3(m1, flat(det_m1), zv_b),
        m2=cat3(m2, flat(det_m2),
                jnp.full_like(zu_b, cfg.disparityBirth)),
        c00=cat3(c00, flat(take_sel(u00)), jnp.full_like(zu_b, var_u)),
        c01=cat3(c01, flat(take_sel(u01)), jnp.zeros_like(zu_b)),
        c02=cat3(c02, flat(take_sel(u02)), jnp.zeros_like(zu_b)),
        c11=cat3(c11, flat(take_sel(u11)), jnp.full_like(zu_b, var_v)),
        c12=cat3(c12, flat(take_sel(u12)), jnp.zeros_like(zu_b)),
        c22=cat3(c22, flat(take_sel(u22)),
                 jnp.full_like(zu_b, cfg.stdDBirth ** 2)),
    )

    if cfg.mergeMode == 1:
        from phdslam_tpu.ops.gm import fast_prune_renormalize
        cand_w = fast_prune_renormalize(cand_w, cfg.mergeMinWeight)
    from phdslam_tpu.filter.step import _pshard
    (mw, mm0, mm1, mm2, mc00, mc01, mc02, mc11, mc12,
     mc22) = _pshard(
        pmesh,
        lambda *ch: greedy_merge_channels3(
            *ch, cfg.minSeparation, F),
        (cand_w, cand["m0"], cand["m1"], cand["m2"], cand["c00"],
         cand["c01"], cand["c02"], cand["c11"], cand["c12"], cand["c22"]),
        ())

    # ---- 8. sample merged Gaussians back to particle clouds -------------
    su, sv, sd = sample_gaussians(
        k_sample, mm0, mm1, mm2, mc00, mc01, mc02, mc11, mc12, mc22, Npp)
    nx, ny, nz = disparity_to_world(su, sv, sd, pose[:, None, None, :], cfg)

    # union merged (in-fov content) with out-of-fov pass-through clouds
    w_out = jnp.where(~in_fov & (state.w > 0), state.w, 0.0)
    cat = lambda a, b: jnp.concatenate([a, b], axis=1)
    top_uw, u_idx = jax.lax.top_k(cat(mw, w_out), F)
    take_u2 = lambda a, b: jnp.take_along_axis(
        cat(a, b), u_idx[..., None], axis=1)
    new_px = take_u2(nx, state.px)
    new_py = take_u2(ny, state.py)
    new_pz = take_u2(nz, state.pz)

    # gate the whole update on measurement presence
    has_z = n_measure > 0
    new_w = jnp.where(has_z, top_uw, state.w)
    new_px = jnp.where(has_z, new_px, state.px)
    new_py = jnp.where(has_z, new_py, state.py)
    new_pz = jnp.where(has_z, new_pz, state.pz)
    lw_new = jnp.where(has_z, state.log_weights + dw, state.log_weights)
    log_norm_total = jax.scipy.special.logsumexp(lw_new)
    lw_new = jnp.where(has_z, lw_new - log_norm_total, lw_new)

    # ---- expected pose + resample ----
    w_lin = jnp.exp(lw_new)
    exp_pose = jnp.sum(w_lin[:, None] * pose, axis=0)
    from phdslam_tpu.ops.resample import neff, stratified_resample_indices
    n_eff = neff(lw_new)
    trigger = (n_eff <= cfg.resampleThresh) & has_z
    res_idx = stratified_resample_indices(k_res, lw_new, P)
    idx = jnp.where(trigger, res_idx, jnp.arange(P, dtype=jnp.int32))
    lw_final = jnp.where(trigger, jnp.full((P,), -jnp.log(float(P)), dtype),
                         lw_new)
    take_p = lambda x: jnp.take(x, idx, axis=0)
    state = DisparityState(
        pose=take_p(pose), log_weights=lw_final, w=take_p(new_w),
        px=take_p(new_px), py=take_p(new_py), pz=take_p(new_pz),
        resample_idx=idx)
    return state, DispAux(expected_pose=exp_pose, neff=n_eff,
                          n_measure=n_measure)


@partial(jax.jit,
         static_argnames=("cfg", "length", "with_map_log", "pmesh"))
def run_disparity_scan(state: DisparityState, key, zs_rb, zs_valid,
                       cfg: SlamConfig, length: int,
                       with_map_log: bool = False, pmesh=None):
    """Whole-dataset `lax.scan` over disparity_step (the SC-PHD analog of
    filter.step.run_scan): one dispatch for the full run, without the
    per-step dispatch and host sync that loop mode pays. Carries the
    per-step pose/weight state for the pose log contract (full feature
    clouds are too large to stack per step; the map log uses the
    O(F)/step fitted summary below).

    with_map_log additionally stacks the MAP particle's per-step world
    feature summary (w [F], cloud means [F, 3], cloud covariances
    [F, 3, 3] — O(F) per step, the 3-D map-OSPA scoring input and the
    scan-mode map-log payload; the full clouds stay step-local).

    zs_rb [T, M, 2]; zs_valid [T, M]. Returns (final_state,
    (stacked DispAux, stacked (log_weights, poses, resample_idx)
    [, stacked (map_w, map_mean, map_cov)]))."""
    keys = jax.random.split(key, length)
    t_idx = jnp.arange(length)

    def body(st, inp):
        k, rb, valid, t = inp
        st, aux = disparity_step(st, k, rb, valid, jnp.float32(cfg.dt),
                                 t > 0, cfg, pmesh=pmesh)
        outs = (aux, (st.log_weights, st.pose, st.resample_idx))
        if with_map_log:
            idx = jnp.argmax(st.log_weights)
            px, py, pz = st.px[idx], st.py[idx], st.pz[idx]   # [F, Npp]
            mean = jnp.stack([px.mean(-1), py.mean(-1), pz.mean(-1)],
                             axis=-1)                          # [F, 3]
            den = 1.0 / max(px.shape[-1] - 1, 1)
            dx = px - mean[:, 0:1]
            dy = py - mean[:, 1:2]
            dz = pz - mean[:, 2:3]
            c = lambda a, b: jnp.sum(a * b, -1) * den
            cov = jnp.stack([
                jnp.stack([c(dx, dx), c(dx, dy), c(dx, dz)], -1),
                jnp.stack([c(dx, dy), c(dy, dy), c(dy, dz)], -1),
                jnp.stack([c(dx, dz), c(dy, dz), c(dz, dz)], -1)],
                axis=-2)                                       # [F, 3, 3]
            outs = outs + ((st.w[idx], mean, cov),)
        return st, outs

    return jax.lax.scan(body, state, (keys, zs_rb, zs_valid, t_idx))


def _map_world_gaussians(state: DisparityState):
    """Fit world-frame Gaussians to the MAP particle's feature clouds
    (host-side numpy): (w [K], mean [K,3], cov [K,3,3])."""
    import numpy as np

    idx = int(np.argmax(np.asarray(state.log_weights)))
    w = np.asarray(state.w[idx])
    sel = w > 0
    pts = np.stack([np.asarray(state.px[idx]), np.asarray(state.py[idx]),
                    np.asarray(state.pz[idx])], axis=-1)[sel]  # [K, Npp, 3]
    if pts.size == 0:
        return w[sel], np.zeros((0, 3)), np.zeros((0, 3, 3))
    mean = pts.mean(axis=1)
    d = pts - mean[:, None]
    cov = np.einsum("kni,knj->kij", d, d) / max(pts.shape[1] - 1, 1)
    return w[sel], mean, cov


def run_disparity(cfg: SlamConfig, args):
    """Disparity-pipeline runner (run_disparity, src/main.cpp:1324-1440):
    per-step expected-pose recovery + state_estimate log (pose line is the
    12-dof camera state, map line the MAP particle's world-frame fitted
    Gaussians, stride 13), loopTime.log, metrics.jsonl, NaN abort
    (src/main.cpp:1423-1428)."""
    import os
    import time

    import numpy as np

    from phdslam_tpu.io import loaders, logs

    data_dir = args.data_dir or cfg.dataDirectory
    meas_path = args.measurements or os.path.join(data_dir,
                                                  "measurements.txt")
    sets = loaders.load_measurements(meas_path)  # (u, v) pairs per line
    n_steps = len(sets)
    if cfg.nSteps > 0:
        n_steps = min(n_steps, cfg.nSteps)
    rb, _, valid = loaders.pad_measurement_sets(sets, cfg.maxMeasurements)

    out_dir = args.out_dir
    os.makedirs(out_dir, exist_ok=True)
    state = DisparityState.create(cfg)
    # +-0.03 rad roll/yaw jitter on the initial states (src/main.cpp:1365-71)
    key = jax.random.PRNGKey(args.seed)
    key, k0 = jax.random.split(key)
    jitter = jax.random.uniform(k0, (cfg.n_particles, 2),
                                minval=-0.03, maxval=0.03)
    state = state.replace(pose=state.pose.at[:, 3].add(jitter[:, 0])
                          .at[:, 5].add(jitter[:, 1]))

    if getattr(args, "mode", "loop") == "scan":
        t0 = time.time()
        final, (auxs, (lws, poses_p, ridx),
                (map_w, map_mean, map_cov)) = run_disparity_scan(
            state, key, jnp.asarray(rb[:n_steps]),
            jnp.asarray(valid[:n_steps]), cfg, n_steps,
            with_map_log=True)
        poses = np.asarray(auxs.expected_pose)   # host fetch == sync
        elapsed = time.time() - t0
        map_w = np.asarray(map_w)
        map_mean = np.asarray(map_mean)
        map_cov = np.asarray(map_cov)
        neffs = np.asarray(auxs.neff)
        nan_steps = np.flatnonzero(~np.isfinite(neffs))
        t_valid = int(nan_steps[0]) if nan_steps.size else n_steps
        if t_valid < n_steps:
            print(f"nan weights detected at step {t_valid}! "
                  "truncating outputs...")
        ms_step = elapsed / n_steps * 1000
        for t in range(t_valid):
            logs.append_loop_time(out_dir, ms_step)
            if not getattr(args, "no_logs", False):
                # full log contract: the scan stacks the MAP particle's
                # per-step fitted world Gaussians (O(F)/step), so scan
                # mode writes the same map line as loop mode
                sel = map_w[t] > 0
                logs.write_state_estimate_log(
                    out_dir, t, poses[t],
                    map_w[t][sel], map_mean[t][sel], map_cov[t][sel],
                    particle_log_weights=np.asarray(lws[t]),
                    particle_poses=np.asarray(poses_p[t]),
                    resample_idx=np.asarray(ridx[t]),
                    max_cardinality=cfg.maxCardinality)
            logs.append_metrics_jsonl(out_dir, dict(
                t=t, ms=ms_step, neff=float(neffs[t]),
                n_measure=int(np.asarray(auxs.n_measure[t]))))
        print(f"disparity scan: {n_steps} steps in {elapsed:.3f}s "
              f"({ms_step:.2f} ms/step)")
        return dict(state=final, poses=poses[:t_valid],
                    ms_per_step=ms_step)

    poses_out = []
    start_t = 0
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    if getattr(args, "resume", False):
        from phdslam_tpu import checkpoint as ckpt
        latest = ckpt.latest_checkpoint(ckpt_dir)
        if latest:
            state, key, start_t = ckpt.restore_checkpoint(latest)
            start_t += 1
            print(f"resumed from {latest} at step {start_t}")
    ckpt_every = getattr(args, "checkpoint_every", 0)
    for t in range(start_t, n_steps):
        t0 = time.time()
        key, sk = jax.random.split(key)
        state, aux = disparity_step(
            state, sk, jnp.asarray(rb[t]), jnp.asarray(valid[t]),
            jnp.float32(cfg.dt), jnp.asarray(t > 0), cfg)
        jax.block_until_ready(state)
        neff_val = float(np.asarray(aux.neff))
        elapsed_ms = (time.time() - t0) * 1000
        logs.append_loop_time(out_dir, elapsed_ms)
        exp_pose = np.asarray(aux.expected_pose)
        poses_out.append(exp_pose)
        if not getattr(args, "no_logs", False):
            mw, mmean, mcov = _map_world_gaussians(state)
            logs.write_state_estimate_log(
                out_dir, t, exp_pose, mw, mmean, mcov,
                particle_log_weights=np.asarray(state.log_weights),
                particle_poses=np.asarray(state.pose),
                resample_idx=np.asarray(state.resample_idx),
                max_cardinality=cfg.maxCardinality)
        map_idx = int(np.argmax(np.asarray(state.log_weights)))
        logs.append_metrics_jsonl(out_dir, dict(
            t=t, ms=elapsed_ms, neff=neff_val,
            n_measure=int(np.asarray(aux.n_measure)),
            card=float(np.asarray(state.w[map_idx]).sum())))
        if ckpt_every and t > 0 and t % ckpt_every == 0:
            from phdslam_tpu import checkpoint as ckpt
            ckpt.save_checkpoint(ckpt_dir, t, state, key)
        if np.isnan(neff_val):
            print("nan weights detected! exiting...")
            break
        if args.verbose:
            print(f"step {t}/{n_steps} neff={neff_val:.3f} "
                  f"pose={exp_pose[:3]}")
    return dict(state=state, poses=np.asarray(poses_out))
