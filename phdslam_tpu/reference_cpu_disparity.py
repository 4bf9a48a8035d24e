"""CPU reference for the monocular SC-PHD disparity pipeline: a faithful,
dynamic-shape NumPy implementation (float64), the independent correctness
anchor for the fixed-shape JAX path in filter/disparity.py.

Follows the reference's disparity pipeline semantics
(/root/reference/src/phdfilter.cu:4520-5216) with host-style control flow —
dynamic per-particle feature lists, no padding/masking/top-k:

  camera predict   disparityPredict (:4520-4570): camera-frame CV
                   translation rotated to world, wrapped angles
  transforms       world<->disparity thrust functors (:3974-4046),
                   baseline-1 disparity space
  fit              fitGaussiansKernel (:4133-4248): sample mean + /(n-1)
                   covariance of each feature's disparity cloud
  gate             is_inrange on the fitted mean (:4100-4126)
  pre-update       preUpdateDisparityKernel (:4306-4373): H = [I2 | 0]
                   picks (u, v); Joseph-form covariance
  update           the shared SC-PHD update: per-measurement normalizers
                   sum_exp + clutterDensity + birthWeight, births at
                   (u, v, disparityBirth) with diag(stdU^2, stdV^2,
                   stdDBirth^2) (:4846-4871)
  merge            greedy 3-D moment matching (:4977-4983); out-of-FOV
                   clouds bypass the merge and pass through untouched
  sample           sampleGaussiansKernel (:4250-4304): redraw each merged
                   Gaussian as a particle cloud, disparity -> world

Because the cloud resampling draws fresh randoms, parity with the JAX path
is statistical (same-scenario tracking error / cardinality), not bitwise —
same situation as the reference's own GPU nondeterminism.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from phdslam_tpu.config import SlamConfig


def _rotation(pose):
    """Camera->world rotation matrix (src/phdfilter.cu:3906-3914)."""
    roll, pitch, yaw = pose[3], pose[4], pose[5]
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.array([
        [cp * cy, cr * sy + sr * sp * cy, sr * sy - cr * sp * cy],
        [-cp * sy, cr * cy - sr * sp * sy, sr * cy + cr * sp * sy],
        [sp, -sr * cp, cr * cp]])


def world_to_disparity_np(pts, pose, cfg):
    """pts [..., 3] world -> (u, v, d) [..., 3] disparity."""
    r = _rotation(pose)
    pc = (pts - pose[:3]) @ r          # rows of r^T applied: p @ r == r.T p
    zc = np.where(np.abs(pc[..., 2]) < 1e-12, 1e-12, pc[..., 2])
    u = cfg.u0 - cfg.fx * pc[..., 0] / zc
    v = cfg.v0 - cfg.fy * pc[..., 1] / zc
    d = -cfg.fx / zc
    return np.stack([u, v, d], axis=-1)


def disparity_to_world_np(uvd, pose, cfg):
    """(u, v, d) [..., 3] -> world [..., 3]."""
    d = np.where(np.abs(uvd[..., 2]) < 1e-12, 1e-12, uvd[..., 2])
    xc = (uvd[..., 0] - cfg.u0) / d
    yc = cfg.fx / cfg.fy * (uvd[..., 1] - cfg.v0) / d
    zc = -cfg.fx / d
    r = _rotation(pose)
    return np.stack([xc, yc, zc], axis=-1) @ r.T + pose[:3]


def camera_predict_np(pose, cfg, dt, rng):
    """6-DOF CV prediction with acceleration noise (disparityPredict)."""
    noise = rng.standard_normal(6) * np.array(
        [cfg.ax, cfg.ay, cfg.az, cfg.aroll, cfg.apitch, cfg.ayaw])
    dc = dt * pose[6:9] + 0.5 * noise[:3] * dt * dt
    dw = _rotation(pose) @ dc
    out = pose.copy()
    out[:3] += dw
    ang = pose[3:6] + dt * pose[9:12] + 0.5 * noise[3:] * dt * dt
    out[3:6] = np.arctan2(np.sin(ang), np.cos(ang))
    out[6:12] = pose[6:12] + dt * noise
    return out


@dataclass
class CpuDispParticle:
    pose: np.ndarray       # [12]
    log_weight: float
    w: np.ndarray          # [K]
    clouds: np.ndarray     # [K, Npp, 3] world points


def create(cfg: SlamConfig, rng) -> List[CpuDispParticle]:
    n = cfg.n_particles
    pose0 = np.array([cfg.x0, cfg.y0, cfg.z0, cfg.roll0, cfg.pitch0,
                      cfg.yaw0, cfg.vx0, cfg.vy0, cfg.vz0, cfg.vroll0,
                      cfg.vpitch0, cfg.vyaw0], np.float64)
    parts = []
    for _ in range(n):
        p = pose0.copy()
        # +-0.03 rad roll/yaw jitter (src/main.cpp:1365-1371)
        p[3] += rng.uniform(-0.03, 0.03)
        p[5] += rng.uniform(-0.03, 0.03)
        parts.append(CpuDispParticle(
            p, -np.log(n), np.zeros(0),
            np.zeros((0, cfg.particlesPerFeature, 3))))
    return parts


def step(particles: List[CpuDispParticle], z_uv: np.ndarray,
         cfg: SlamConfig, dt, rng, do_predict=True):
    """One SC-PHD step over all particles. z_uv [M, 2]. Mutates."""
    m_count = len(z_uv)
    npp = cfg.particlesPerFeature
    clutter_density = cfg.clutterRate / (cfg.imageWidth * cfg.imageHeight)
    var_u, var_v = cfg.stdU ** 2, cfg.stdV ** 2
    R2 = np.diag([var_u, var_v])

    for p in particles:
        if do_predict:
            p.pose = camera_predict_np(p.pose, cfg, dt, rng)
        if m_count == 0:
            continue
        K = len(p.w)

        # world -> disparity, fit 3-D Gaussians per cloud
        if K:
            uvd = world_to_disparity_np(p.clouds, p.pose, cfg)  # [K,Npp,3]
            mu = uvd.mean(axis=1)                               # [K, 3]
            d0 = uvd - mu[:, None]
            cov = np.einsum("kni,knj->kij", d0, d0) / (npp - 1)
            in_fov = ((mu[:, 0] > 0) & (mu[:, 0] <= cfg.imageWidth)
                      & (mu[:, 1] >= 0) & (mu[:, 1] <= cfg.imageHeight)
                      & (mu[:, 2] >= 0) & (p.w > 0))
        else:
            in_fov = np.zeros(0, bool)
        w_in = p.w[in_fov]
        mu_in = mu[in_fov] if K else np.zeros((0, 3))
        P_in = cov[in_fov] if K else np.zeros((0, 3, 3))
        n_f = len(w_in)

        # EKF pre-update, H = [I2 | 0]
        comps_w, comps_mu, comps_P = [], [], []
        log_norms = np.zeros(m_count)
        if n_f:
            S = P_in[:, :2, :2] + R2
            det_s = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
            s_inv = np.stack([
                np.stack([S[:, 1, 1], -S[:, 0, 1]], -1),
                np.stack([-S[:, 1, 0], S[:, 0, 0]], -1)], -2) \
                / det_s[:, None, None]
            Kg = np.einsum("fij,fjk->fik", P_in[:, :, :2], s_inv)  # [f,3,2]
            IKH = np.eye(3)[None] - np.concatenate(
                [Kg, np.zeros((n_f, 3, 1))], axis=2)
            P_up = np.einsum("fij,fjk,flk->fil", IKH, P_in, IKH) \
                + np.einsum("fij,jk,flk->fil", Kg, R2, Kg)
            pd = cfg.pd
            # nondetect terms
            comps_w.append(w_in * (1 - pd))
            comps_mu.append(mu_in)
            comps_P.append(P_in)
            for mi in range(m_count):
                innov = z_uv[mi] - mu_in[:, :2]                 # [f, 2]
                dist = np.einsum("fi,fij,fj->f", innov, s_inv, innov)
                lw = (np.log(pd) + np.log(w_in.clip(1e-300))
                      - 0.5 * dist - np.log(2 * np.pi)
                      - 0.5 * np.log(det_s))
                sum_exp = np.exp(lw).sum()
                norm = sum_exp + clutter_density + cfg.birthWeight
                log_norms[mi] = np.log(norm)
                comps_w.append(np.exp(lw - log_norms[mi]))
                comps_mu.append(
                    mu_in + np.einsum("fij,fj->fi", Kg, innov))
                comps_P.append(P_up)
        else:
            log_norms[:] = np.log(clutter_density + cfg.birthWeight)

        # births at (u, v, disparityBirth)
        bmu = np.concatenate(
            [z_uv, np.full((m_count, 1), cfg.disparityBirth)], axis=1)
        bP = np.tile(np.diag([var_u, var_v, cfg.stdDBirth ** 2]),
                     (m_count, 1, 1))
        comps_w.append(cfg.birthWeight / np.exp(log_norms))
        comps_mu.append(bmu)
        comps_P.append(bP)

        uw = np.concatenate(comps_w)
        umu = np.concatenate(comps_mu)
        uP = np.concatenate(comps_P)

        # particle weight (weighting 0, the pipeline's scheme)
        card_pred = float(n_f and np.sum(cfg.pd * w_in)) \
            + m_count * cfg.birthWeight
        p.log_weight += float(log_norms.sum() - card_pred)

        # prune + greedy 3-D merge of the in-FOV content
        keep = uw >= cfg.minFeatureWeight
        uw, umu, uP = uw[keep], umu[keep], uP[keep]
        mw, mmu, mP = _greedy_merge3(uw, umu, uP, cfg)

        # sample merged Gaussians back to clouds, disparity -> world
        new_clouds = np.zeros((len(mw), npp, 3))
        for k in range(len(mw)):
            try:
                L = np.linalg.cholesky(mP[k])
            except np.linalg.LinAlgError:
                L = np.diag(np.sqrt(np.maximum(np.diag(mP[k]), 1e-9)))
            x = rng.standard_normal((npp, 3))
            new_clouds[k] = disparity_to_world_np(
                mmu[k] + x @ L.T, p.pose, cfg)

        # union with out-of-FOV pass-through clouds
        out_sel = ~in_fov & (p.w > 0)
        p.w = np.concatenate([mw, p.w[out_sel]])
        p.clouds = np.concatenate([new_clouds, p.clouds[out_sel]]) \
            if len(mw) or out_sel.any() else np.zeros((0, npp, 3))

    if m_count == 0:
        return
    # weight normalization
    lws = np.array([p.log_weight for p in particles])
    mx = lws.max()
    total = mx + np.log(np.exp(lws - mx).sum())
    for p in particles:
        p.log_weight -= total


def _greedy_merge3(w, mu, P, cfg: SlamConfig):
    """Greedy max-weight 3-D moment matching (the Gaussian3D overload of
    phdUpdateMergeKernel); Mahalanobis with averaged covariances."""
    n = len(w)
    merged_w, merged_mu, merged_P = [], [], []
    alive = w > 0
    w = w.copy()
    for _ in range(n):
        if not alive.any():
            break
        pick = np.argmax(np.where(alive, w, -1))
        sig = 0.5 * (P[pick][None] + P)
        diff = mu[pick][None] - mu
        dist = np.full(n, np.inf)
        for j in np.flatnonzero(alive):
            try:
                L = np.linalg.cholesky(sig[j])
                x = np.linalg.solve(L, diff[j])
                dist[j] = float(x @ x)
            except np.linalg.LinAlgError:
                pass
        sel = alive & (dist < cfg.minSeparation)
        sel[pick] = True
        sw = w[sel]
        wsum = sw.sum()
        m = (sw[:, None] * mu[sel]).sum(0) / wsum
        dd = m[None] - mu[sel]
        cc = (sw[:, None, None]
              * (P[sel] + dd[:, :, None] * dd[:, None, :])).sum(0) / wsum
        merged_w.append(wsum)
        merged_mu.append(m)
        merged_P.append(0.5 * (cc + cc.T))
        alive &= ~sel
    if not merged_w:
        return np.zeros(0), np.zeros((0, 3)), np.zeros((0, 3, 3))
    return (np.asarray(merged_w), np.asarray(merged_mu),
            np.asarray(merged_P))


def expected_pose(particles):
    w = np.exp([p.log_weight for p in particles])
    poses = np.stack([p.pose for p in particles])
    return (w[:, None] * poses).sum(0)


def run(cfg: SlamConfig, measurement_sets, seed=0, callback=None):
    """Full CPU disparity filter over a measurement stream. Returns stacked
    expected camera poses [T, 12]."""
    rng = np.random.default_rng(seed)
    particles = create(cfg, rng)
    out = []
    for t, z in enumerate(measurement_sets):
        step(particles, np.asarray(z, np.float64), cfg, cfg.dt, rng,
             do_predict=t > 0)
        out.append(expected_pose(particles))
        lws = np.array([p.log_weight for p in particles])
        n_eff = 1.0 / np.sum(np.exp(2 * lws)) / len(lws)
        if n_eff <= cfg.resampleThresh and len(z):
            w = np.exp(lws)
            csum = np.cumsum(w)
            pos = (np.arange(len(particles))
                   + rng.uniform(size=len(particles))) / len(particles)
            idx = np.minimum(np.searchsorted(csum, pos),
                             len(particles) - 1)
            particles[:] = [CpuDispParticle(
                particles[i].pose.copy(), -np.log(len(particles)),
                particles[i].w.copy(), particles[i].clouds.copy())
                for i in idx]
        if callback:
            callback(t, particles)
    return np.asarray(out)
