"""Mixed-model (static landmarks + moving targets) evidence: MC envelope
on the JAX path + CPU-oracle cross-check — gives the mixed family the same
RESULTS treatment as the static/CPHD/disparity rows.

Scenario: the loop-closure MC map (40 landmarks) plus 3 slow constant-
velocity movers crossing the vehicle's loop; measurements are UNLABELED so
the filter must separate static from dynamic itself (the reference's
unlabeled mixed mode, src/phdfilter.cu:2501-2503).

Scores per run: per-step pose error; at EVERY post-burn-in step where a
mover is inside the true sensor FOV, the distance from its true position
to the nearest dynamic-map feature of the per-step MAP particle (from
run_scan's LogAux), plus the velocity-direction cosine. Per-step scoring
over the whole in-FOV window is the robust statistic — a mover is only
distinguishable from a static landmark once its velocity estimate has
accumulated, and final-step-only scoring mostly measured movers that had
already left the FOV. Movers cross the vehicle loop at ~0.25 m/s so the
velocity axis is genuinely observable over a visit. CPU leg:
reference_cpu.update_mixed at 16 particles on run 0's stream.

Usage: python \
           scripts/mixed_evidence.py [--quick]
"""

from __future__ import annotations

import json
import os
import sys
import time


import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

QUICK = "--quick" in sys.argv
SMOKE = "--smoke" in sys.argv   # tiny shapes: code-path check on 1-core CPU
INFORMED = "--informed" in sys.argv  # birthVelocityInit=True variant
                                     # (two-detection velocity init,
                                     # VERDICT r3 item 6); results recorded
                                     # under the "mixed_informed" key
# extra cfg overrides: --set key=value (repeatable); appended to the
# output key so variants don't clobber each other
LABELED = "--labeled" in sys.argv  # the reference's LABELED mixed mode:
                                   # measurements carry static/dynamic
                                   # labels and the update label-gates
                                   # (src/phdfilter.cu:1913-1921)
OVERRIDES = {}
for _i, _a in enumerate(sys.argv):
    if _a == "--set" and _i + 1 < len(sys.argv):
        _k, _v = sys.argv[_i + 1].split("=")
        OVERRIDES[_k] = float(_v)

MOVER0 = np.array([[13.0, 9.0], [-9.0, 12.0], [10.0, -6.0]])
MOVER_V = np.array([[-0.22, -0.10], [0.20, -0.12], [-0.14, 0.18]])


def main():
    import jax
    import jax.numpy as jnp

    from phdslam_tpu.config import load_config
    from phdslam_tpu.filter.state import Measurements, SlamState
    from phdslam_tpu.filter.step import run_scan
    from phdslam_tpu.simdata import generate_mixed_run, make_scenario
    from phdslam_tpu.utils import configure_compile_cache

    configure_compile_cache()
    T = 12 if SMOKE else 40 if QUICK else 150
    n_runs = 1 if SMOKE else 2 if QUICK else 10
    sc = make_scenario(np.random.default_rng(11), n_landmarks=40,
                      n_steps=T)
    # base = the SHIPPED mixed defaults (cfg/mixed_synth.cfg — incl.
    # birth_weight_dynamic = 0.05) with run_batch's MC contract on top
    # (scenario-aligned start pose, control noise (0.2, 0.01)); shape
    # overrides only
    cfg = load_config("cfg/mixed_synth.cfg").replace(
        n_particles=32 if SMOKE else 256,
        maxFeatures=32 if SMOKE else 128,
        maxMeasurements=16 if SMOKE else 64,
        birthVelocityInit=INFORMED, labeledMeasurements=LABELED,
        x0=float(sc.traj[0, 0]), y0=float(sc.traj[0, 1]),
        yaw0=float(sc.traj[0, 2]))
    if OVERRIDES:
        cast = {k: type(getattr(cfg, k))(v) for k, v in OVERRIDES.items()}
        cfg = cfg.replace(**cast)
    out_key = ("mixed_informed" if INFORMED else "mixed") \
        + ("_labeled" if LABELED else "") + "".join(
            f"_{k}{v:g}" for k, v in sorted(OVERRIDES.items()))

    pose_err = np.zeros((n_runs, T))
    mover_dist = []
    vel_cos = []
    settled_dist = []      # >= 4th consecutive in-FOV step: the filter has
    settled_cos = []       # had birth + a few detections to accumulate
    settled_dist_rel = []  # settled distance in the MAP particle's own
                           # frame (SE(2)-aligned): mixed-subsystem
                           # quality with the SLAM pose error removed
    settled_dist_any = []  # nearest dynamic feature with ANY weight
                           # > 0.01 (selection threshold removed):
                           # separates 'mover not tracked' from 'tracked
                           # but below the existence threshold'
    settled_nearest_w = []  # weight of that nearest feature
    oracle_settled = []    # CRLB-style bound: known-association Kalman at
                           # the TRUE vehicle pose, scored on the same
                           # settled steps — the ceiling ANY filter can
                           # reach on these measurement streams
    dyn_mass = np.zeros(n_runs)
    ms_per_step = []

    def oracle_track(meas, truth, T):
        """Per-mover 4-state CV Kalman with oracle association (nearest
        measurement to the TRUE position within a 3-sigma gate, world
        frame at the TRUE pose). Returns est [T, K, 2] (nan before the
        first detection)."""
        Kn = truth.shape[1]
        est = np.full((T, Kn, 2), np.nan)
        x = [None] * Kn
        Pm = [None] * Kn
        dtv = sc.dt
        F = np.eye(4)
        F[0, 2] = F[1, 3] = dtv
        q = 1e-4          # movers are exactly CV; tiny for conditioning
        Q = np.diag([0.25 * q * dtv ** 4] * 2 + [q * dtv ** 2] * 2)
        H = np.zeros((2, 4))
        H[0, 0] = H[1, 1] = 1.0
        for t in range(T):
            vp = sc.traj[t]
            z = meas[t]
            if len(z):
                zw = np.stack(
                    [vp[0] + z[:, 0] * np.cos(vp[2] + z[:, 1]),
                     vp[1] + z[:, 0] * np.sin(vp[2] + z[:, 1])], axis=1)
            for k in range(Kn):
                if x[k] is not None:
                    x[k] = F @ x[k]
                    Pm[k] = F @ Pm[k] @ F.T + Q
                pos = truth[t, k]
                r_true = np.linalg.norm(pos - vp[:2])
                var_p = (cfg.stdRange ** 2
                         + (r_true * cfg.stdBearing) ** 2)
                if len(z):
                    dd = np.linalg.norm(zw - pos, axis=1)
                    j = int(np.argmin(dd))
                    if dd[j] < 3.0 * np.sqrt(var_p):
                        R = var_p * np.eye(2)
                        if x[k] is None:
                            x[k] = np.array([zw[j, 0], zw[j, 1], 0., 0.])
                            Pm[k] = np.diag([var_p, var_p,
                                             cfg.covVxBirth,
                                             cfg.covVyBirth])
                        else:
                            S = H @ Pm[k] @ H.T + R
                            G = Pm[k] @ H.T @ np.linalg.inv(S)
                            x[k] = x[k] + G @ (zw[j] - H @ x[k])
                            Pm[k] = (np.eye(4) - G @ H) @ Pm[k]
                if x[k] is not None:
                    est[t, k] = x[k][:2]
        return est
    for run in range(n_runs):
        rng = np.random.default_rng(500 + run)
        controls, meas, truth, z_labels = generate_mixed_run(
            rng, sc, MOVER0, MOVER_V, control_noise=(0.2, 0.01),
            return_labels=True)
        oracle_est = oracle_track(meas, truth, T)
        M = cfg.maxMeasurements
        rb = np.zeros((T, M, 2), np.float32)
        valid = np.zeros((T, M), bool)
        lab = np.zeros((T, M), np.int32)
        for t in range(T):
            z = meas[t][:M]
            rb[t, :len(z)] = z
            valid[t, :len(z)] = True
            if LABELED:
                lab[t, :len(z)] = z_labels[t][:M]
        state = SlamState.create(cfg)
        zs = Measurements(rb=jnp.asarray(rb),
                          label=jnp.asarray(lab),
                          valid=jnp.asarray(valid))
        ctrl = jnp.asarray(np.concatenate(
            [np.zeros((1, 2), np.float32), controls[:T - 1]]))
        dts = jnp.full((T,), cfg.dt, jnp.float32)
        t0 = time.time()
        final, (auxs, la) = run_scan(state, jax.random.PRNGKey(run), ctrl,
                                     zs, dts, cfg, T, with_log_state=True)
        poses = np.asarray(auxs.expected_pose)       # sync
        ms_per_step.append((time.time() - t0) / T * 1000)
        pose_err[run] = np.linalg.norm(
            poses[:, :2] - sc.traj[:T, :2], axis=1)

        dyn_mass[run] = float(np.asarray(final.map_dynamic.w[
            int(np.argmax(np.asarray(final.log_weights)))]).sum())
        dyn_w_all = np.asarray(la.dyn_w)              # [T, Fd]
        dyn_m_all = np.asarray(la.dyn_mean)           # [T, 4, Fd]
        lw_all = np.asarray(la.log_weights)           # [T, P]
        poses_all = np.asarray(la.poses)              # [T, P, 6]
        map_pose = poses_all[np.arange(T), lw_all.argmax(axis=1)]  # [T,6]
        burn = max(10, T // 5)
        scored_before = len(mover_dist)
        # consecutive in-FOV step count per mover (resets when it leaves)
        streak = np.zeros(MOVER0.shape[0], int)
        # seed streaks over the pre-burn window so a dwell spanning the
        # burn boundary counts its full consecutive in-FOV length
        for t in range(burn):
            vpose = sc.traj[t]
            for k in range(MOVER0.shape[0]):
                d = truth[t, k] - vpose[:2]
                r = np.linalg.norm(d)
                b = np.arctan2(d[1], d[0]) - vpose[2]
                b = np.arctan2(np.sin(b), np.cos(b))
                if (cfg.minRange <= r <= cfg.maxRange
                        and abs(b) <= cfg.maxBearing):
                    streak[k] += 1
                else:
                    streak[k] = 0
        for t in range(burn, T):
            w4 = dyn_w_all[t]
            m4 = dyn_m_all[t].T                       # [Fd, 4] = x,y,vx,vy
            # feature-existence threshold: the MAP-map convention (top
            # round(sum w) features) with a floor of the strongest
            # quarter — the dynamic map spreads each mover's ~unit mass
            # over a few components, so the static map's 0.33 absolute
            # cut is too strict
            sel = w4 >= max(0.05, 0.25 * float(w4.max()))
            vpose = sc.traj[t]
            for k in range(MOVER0.shape[0]):
                pos = truth[t, k]
                d = pos - vpose[:2]
                r = np.linalg.norm(d)
                b = np.arctan2(d[1], d[0]) - vpose[2]
                b = np.arctan2(np.sin(b), np.cos(b))
                if not (cfg.minRange <= r <= cfg.maxRange
                        and abs(b) <= cfg.maxBearing):
                    streak[k] = 0
                    continue
                streak[k] += 1
                if streak[k] >= 4:
                    oe = oracle_est[t, k]
                    oracle_settled.append(
                        float(np.linalg.norm(oe - pos))
                        if np.isfinite(oe).all() else np.inf)
                if not sel.any():
                    mover_dist.append(np.inf)
                    if streak[k] >= 4:
                        settled_dist.append(np.inf)
                    continue
                dd = np.linalg.norm(m4[sel][:, :2] - pos, axis=1)
                j = int(np.argmin(dd))
                mover_dist.append(float(dd[j]))
                v_est = m4[sel][j, 2:]
                nv = np.linalg.norm(v_est) * np.linalg.norm(MOVER_V[k])
                cos = float(v_est @ MOVER_V[k] / nv) if nv > 0 else None
                if cos is not None:
                    vel_cos.append(cos)
                if streak[k] >= 4:
                    settled_dist.append(float(dd[j]))
                    any_sel = w4 > 0.01
                    if any_sel.any():
                        da = np.linalg.norm(
                            m4[any_sel][:, :2] - pos, axis=1)
                        ja = int(np.argmin(da))
                        settled_dist_any.append(float(da[ja]))
                        settled_nearest_w.append(float(w4[any_sel][ja]))
                    else:
                        settled_dist_any.append(np.inf)
                    # pose-aligned (SE(2) relative-frame) distance: how
                    # well the mover is localized RELATIVE to the MAP
                    # particle's own pose — separates the mixed
                    # subsystem's quality from the SLAM pose error that
                    # displaces the whole world-frame map
                    pe = map_pose[t]
                    ce, se = np.cos(-pe[2]), np.sin(-pe[2])
                    re_ = m4[sel][j, :2] - pe[:2]
                    rel_e = np.array([ce * re_[0] - se * re_[1],
                                      se * re_[0] + ce * re_[1]])
                    ct_, st_ = np.cos(-vpose[2]), np.sin(-vpose[2])
                    rt_ = pos - vpose[:2]
                    rel_t = np.array([ct_ * rt_[0] - st_ * rt_[1],
                                      st_ * rt_[0] + ct_ * rt_[1]])
                    settled_dist_rel.append(
                        float(np.linalg.norm(rel_e - rel_t)))
                    if cos is not None:
                        settled_cos.append(cos)
        print(f"run {run}: pose mean {pose_err[run].mean():.3f} m, "
              f"dyn mass {dyn_mass[run]:.2f}, "
              f"step-movers scored {len(mover_dist) - scored_before}",
              flush=True)

    # ---- paused-dwell leg: in-scenario velocity evidence ----
    # The wandering loop turns fast enough that no constant-velocity
    # mover stays in the FOV longer than ~6 steps, so the main envelope
    # cannot exercise velocity estimation. Here the vehicle HOLDS for 30
    # steps (make_scenario pause) while one mover crosses its FOV — a
    # 33-step uninterrupted dwell — and we score distance + velocity
    # cosine over the post-lock-on window (like the reference's
    # hand-driven hold-and-observe courses).
    Tp = 12 if SMOKE else 120
    n_pause_runs = 1 if SMOKE else 5
    sc_p = make_scenario(np.random.default_rng(11), n_landmarks=40,
                         n_steps=Tp, pause=(60, 30))
    pm0 = np.array([[-5.51416556, -3.72010326]])
    pmv = np.array([[-0.15390214, 0.2575153]])
    p_dist, p_cos = [], []
    for run in range(n_pause_runs):
        rng = np.random.default_rng(900 + run)
        controls, meas, truth, z_labels = generate_mixed_run(
            rng, sc_p, pm0, pmv, control_noise=(0.2, 0.01),
            return_labels=True)
        M = cfg.maxMeasurements
        rb = np.zeros((Tp, M, 2), np.float32)
        valid = np.zeros((Tp, M), bool)
        lab = np.zeros((Tp, M), np.int32)
        for t in range(Tp):
            z = meas[t][:M]
            rb[t, :len(z)] = z
            valid[t, :len(z)] = True
            if LABELED:
                lab[t, :len(z)] = z_labels[t][:M]
        state = SlamState.create(cfg)
        zs = Measurements(rb=jnp.asarray(rb),
                          label=jnp.asarray(lab),
                          valid=jnp.asarray(valid))
        ctrl = jnp.asarray(np.concatenate(
            [np.zeros((1, 2), np.float32), controls[:Tp - 1]]))
        dts = jnp.full((Tp,), cfg.dt, jnp.float32)
        _, (_, la) = run_scan(state, jax.random.PRNGKey(50 + run), ctrl,
                              zs, dts, cfg, Tp, with_log_state=True)
        dyn_w_all = np.asarray(la.dyn_w)
        dyn_m_all = np.asarray(la.dyn_mean)
        lo, hi = (8, Tp) if SMOKE else (68, 93)   # post-lock-on dwell
        for t in range(lo, min(hi, Tp)):
            w4 = dyn_w_all[t]
            m4 = dyn_m_all[t].T
            sel = w4 >= max(0.05, 0.25 * float(w4.max()))
            if not sel.any():
                p_dist.append(np.inf)
                continue
            pos = truth[t, 0]
            dd = np.linalg.norm(m4[sel][:, :2] - pos, axis=1)
            j = int(np.argmin(dd))
            p_dist.append(float(dd[j]))
            v_est = m4[sel][j, 2:]
            nv = np.linalg.norm(v_est) * np.linalg.norm(pmv[0])
            if nv > 0:
                p_cos.append(float(v_est @ pmv[0] / nv))
    pd_arr = np.asarray(p_dist)
    paused = dict(
        n_runs=n_pause_runs, dwell_steps=int(pd_arr.size // max(
            n_pause_runs, 1)),
        dist_mean=round(float(pd_arr[np.isfinite(pd_arr)].mean()), 3)
        if np.isfinite(pd_arr).any() else None,
        dist_under_2m=round(float((pd_arr < 2.0).mean()), 3)
        if pd_arr.size else None,
        cos_mean=round(float(np.mean(p_cos)), 3) if p_cos else None)
    print("paused-dwell leg:", json.dumps(paused), flush=True)

    # ---- CPU-oracle leg on run 0's stream ----
    # Skipped for the informed variant: the oracle doesn't implement the
    # two-detection velocity init, and the informed-vs-baseline comparison
    # is JAX-path-internal (the baseline's oracle anchor stands).
    rng = np.random.default_rng(500)
    controls, meas, truth = generate_mixed_run(
        rng, sc, MOVER0, MOVER_V, control_noise=(0.2, 0.01))
    Tc = 4 if SMOKE else 20 if QUICK else 60
    cfg_cpu = cfg.replace(n_particles=16)
    SKIP_CPU = "--skip-cpu" in sys.argv
    if INFORMED or OVERRIDES or SKIP_CPU or LABELED:
        cpu_ms = float("nan")
        cpu_err = np.full((Tc,), np.nan)
    else:
        from phdslam_tpu import reference_cpu as R
        t0 = time.time()
        poses_cpu = R.run(cfg_cpu, controls[:Tc - 1], meas[:Tc], seed=2)
        cpu_ms = (time.time() - t0) / Tc * 1000
        cpu_err = np.linalg.norm(poses_cpu[:, :2] - sc.traj[:Tc, :2],
                                 axis=1)

    # ---- envelope plot ----
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4))
    ts = np.arange(T)
    m, s = pose_err.mean(0), pose_err.std(0)
    ax.plot(ts, m, label=f"mixed JAX ({cfg.n_particles}p, "
                         f"{n_runs} runs)")
    ax.fill_between(ts, m - s, m + s, alpha=0.25)
    ax.plot(np.arange(Tc), cpu_err, "--",
            label=f"CPU oracle ({cfg_cpu.n_particles}p, 1 run)")
    ax.set_xlabel("time step")
    ax.set_ylabel("pose error [m]")
    ax.legend()
    fig.tight_layout()
    os.makedirs("results", exist_ok=True)
    if not SMOKE:
        suffix = out_key[len("mixed"):]
        fig.savefig(f"results/mixed_envelopes{suffix}.png", dpi=110)

    md = np.asarray(mover_dist)
    out = {}
    out[out_key] = dict(
        birth_velocity_init=INFORMED, overrides=OVERRIDES,
        n_runs=n_runs, steps=T, n_particles=cfg.n_particles,
        pose_mean=round(float(pose_err.mean()), 3),
        pose_late_mean=round(float(pose_err[:, T // 2:].mean()), 3),
        # run 0 pays the scan compile; warm runs are the throughput number
        ms_per_step=round(float(np.mean(ms_per_step[1:])), 2)
        if len(ms_per_step) > 1 else round(float(ms_per_step[0]), 2),
        ms_per_step_cold=round(float(ms_per_step[0]), 2),
        movers_scored=int(md.size),
        mover_dist_mean=round(float(md[np.isfinite(md)].mean()), 3)
        if np.isfinite(md).any() else None,
        mover_dist_under_2m=round(float((md < 2.0).mean()), 3)
        if md.size else None,
        vel_cos_mean=round(float(np.mean(vel_cos)), 3)
        if vel_cos else None,
        settled_scored=int(len(settled_dist)),
        settled_dist_mean=round(float(np.mean(
            [d for d in settled_dist if np.isfinite(d)])), 3)
        if any(np.isfinite(d) for d in settled_dist) else None,
        settled_dist_under_2m=round(float(np.mean(
            [d < 2.0 for d in settled_dist])), 3)
        if settled_dist else None,
        settled_cos_mean=round(float(np.mean(settled_cos)), 3)
        if settled_cos else None,
        settled_dist_any_mean=round(float(np.mean(
            [d for d in settled_dist_any if np.isfinite(d)])), 3)
        if any(np.isfinite(d) for d in settled_dist_any) else None,
        settled_dist_any_under_2m=round(float(np.mean(
            [d < 2.0 for d in settled_dist_any])), 3)
        if settled_dist_any else None,
        settled_nearest_w_mean=round(float(np.mean(settled_nearest_w)), 3)
        if settled_nearest_w else None,
        settled_dist_rel_mean=round(float(np.mean(
            [d for d in settled_dist_rel if np.isfinite(d)])), 3)
        if any(np.isfinite(d) for d in settled_dist_rel) else None,
        settled_dist_rel_under_2m=round(float(np.mean(
            [d < 2.0 for d in settled_dist_rel])), 3)
        if settled_dist_rel else None,
        oracle_settled_dist_mean=round(float(np.mean(
            [d for d in oracle_settled if np.isfinite(d)])), 3)
        if any(np.isfinite(d) for d in oracle_settled) else None,
        oracle_settled_under_2m=round(float(np.mean(
            [d < 2.0 for d in oracle_settled])), 3)
        if oracle_settled else None,
        paused_dwell=paused,
        dyn_mass_mean=round(float(dyn_mass.mean()), 2),
        cpu_n_particles=cfg_cpu.n_particles, cpu_steps=Tc,
        cpu_ms_per_step=None if (INFORMED or OVERRIDES or SKIP_CPU or LABELED)
        else round(cpu_ms, 1),
        cpu_pose_mean=None if (INFORMED or OVERRIDES or SKIP_CPU or LABELED)
        else round(float(cpu_err.mean()), 3),
        engine_pose_mean_cpu_window=round(float(pose_err[0, :Tc].mean()), 3))
    if not SMOKE:
        path = "results/round3_evidence.json"
        data = {}
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
        prev = data.get(out_key, {})
        for ck in ("cpu_ms_per_step", "cpu_pose_mean"):
            if out[out_key].get(ck) is None and prev.get(ck) is not None:
                out[out_key][ck] = prev[ck]
        data.update(out)
        with open(path, "w") as f:
            json.dump(data, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
