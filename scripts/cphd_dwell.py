"""CPHD dwell leg: E[n] must climb to the true in-FOV count when the
vehicle holds still (VERDICT r3 item 2, mechanism demonstration).

cphd_diag/diag2 established that on the shipped Ackerman dataset the
in-FOV intensity mass stays near zero for the PHD filter too — the
forward-moving vehicle's FOV is always unconfirmed territory under heavy
clutter, so E[n] (a submap statistic) correctly reads ~0. The converse
prediction: give the filter a long FOV dwell and E[n] must converge to
the true in-FOV landmark count. This script runs a pause scenario
(vehicle holds 60 steps) and records weight-averaged E[n], submap mass,
and truth n_fov per step -> results/cphd_dwell.json + .png.

Run: python scripts/cphd_dwell.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from phdslam_tpu.utils import configure_compile_cache

configure_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from phdslam_tpu.config import load_config  # noqa: E402


def wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def main():
    from phdslam_tpu.filter.state import Measurements, SlamState
    from phdslam_tpu.filter.step import run_scan
    from phdslam_tpu.simdata import generate_run, make_scenario

    T = 110
    pause = (40, 60)
    sc = make_scenario(np.random.default_rng(5), n_landmarks=40,
                       n_steps=T, pause=pause)
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=256, maxFeatures=128, maxMeasurements=64,
        filterType=1, maxCardinality=127, gateBirths=True,
        gateThreshold=9.0, mapEstimate=2,
        x0=float(sc.traj[0, 0]), y0=float(sc.traj[0, 1]),
        yaw0=float(sc.traj[0, 2]))
    controls, meas = generate_run(np.random.default_rng(17), sc,
                                  control_noise=(0.2, 0.01))
    M = cfg.maxMeasurements
    rb = np.zeros((T, M, 2), np.float32)
    valid = np.zeros((T, M), bool)
    for t in range(T):
        z = meas[t][:M]
        rb[t, :len(z)] = z
        valid[t, :len(z)] = True
    state = SlamState.create(cfg)
    zs = Measurements(rb=jnp.asarray(rb),
                      label=jnp.zeros((T, M), jnp.int32),
                      valid=jnp.asarray(valid))
    ctrl = jnp.asarray(np.concatenate(
        [np.zeros((1, 2), np.float32), controls[:T - 1]]))
    dts = jnp.full((T,), cfg.dt, jnp.float32)
    final, (auxs, la) = run_scan(state, jax.random.PRNGKey(0), ctrl, zs,
                                 dts, cfg, T, with_log_state=True)

    cn = np.asarray(la.cardinality)                       # [T, N+1]
    pmf = np.exp(cn - cn.max(axis=1, keepdims=True))
    pmf /= pmf.sum(axis=1, keepdims=True)
    e_n = (pmf * np.arange(pmf.shape[1])).sum(1)

    lw = np.asarray(la.log_weights)
    all_poses = np.asarray(la.poses)
    map_idx = lw.argmax(axis=1)
    map_pose = all_poses[np.arange(T), map_idx]
    w = np.asarray(la.map_w)
    mx = np.asarray(la.map_mx)
    my = np.asarray(la.map_my)
    dx = mx - map_pose[:, None, 0]
    dy = my - map_pose[:, None, 1]
    r = np.hypot(dx, dy)
    b = wrap(np.arctan2(dy, dx) - map_pose[:, None, 2])
    in_r = ((r >= cfg.minRange) & (r <= cfg.maxRange)
            & (np.abs(b) <= cfg.maxBearing))
    mass_in = (w * in_r).sum(1)

    d = sc.landmarks[None, :, :] - sc.traj[:T, None, :2]
    rt = np.linalg.norm(d, axis=-1)
    bt = wrap(np.arctan2(d[..., 1], d[..., 0]) - sc.traj[:T, 2][:, None])
    fov = ((rt <= cfg.maxRange) & (rt >= cfg.minRange)
           & (np.abs(bt) <= cfg.maxBearing))
    n_fov = fov.sum(1).astype(float)

    lo, hi = pause[0] + 10, pause[0] + pause[1]   # settled dwell window
    err_dwell = np.abs(e_n[lo:hi] - n_fov[lo:hi]).mean()
    out = dict(T=T, pause=pause, e_n=e_n.tolist(), n_fov=n_fov.tolist(),
               mass_in_fov=mass_in.tolist(),
               dwell_window=[lo, hi],
               dwell_err_mean=round(float(err_dwell), 3),
               dwell_e_n_mean=round(float(e_n[lo:hi].mean()), 2),
               dwell_n_fov=round(float(n_fov[lo:hi].mean()), 2))
    os.makedirs("results", exist_ok=True)
    with open("results/cphd_dwell.json", "w") as f:
        json.dump(out, f, indent=1)
    print(f"dwell window {lo}..{hi}: E[n] mean {out['dwell_e_n_mean']} "
          f"vs n_fov {out['dwell_n_fov']}; |err| mean {out['dwell_err_mean']}")
    for t in range(0, T, 5):
        print(f"  {t:3d} E[n]={e_n[t]:6.2f} nfov={n_fov[t]:3.0f} "
              f"massIn={mass_in[t]:6.2f}")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(9, 3.4))
        ax.plot(e_n, label="CPHD E[n]")
        ax.plot(n_fov, "g-", lw=1, label="in-FOV landmarks (truth)")
        ax.plot(mass_in, "--", label="in-FOV intensity mass (MAP)")
        ax.axvspan(pause[0], pause[0] + pause[1], alpha=0.12, color="gray",
                   label="vehicle holds")
        ax.set_xlabel("time step")
        ax.legend(fontsize=8)
        fig.tight_layout()
        fig.savefig("results/cphd_dwell.png", dpi=110)
        print("wrote results/cphd_dwell.png")
    except Exception as e:  # pragma: no cover
        print("plot skipped:", e)


if __name__ == "__main__":
    main()
