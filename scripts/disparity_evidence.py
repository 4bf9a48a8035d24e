"""Disparity (monocular SC-PHD) evidence: re-noised Monte-Carlo envelope
+ per-step 3-D feature-map OSPA vs the shipped landmark truth
(VERDICT r2 item 7).

Re-runs the shipped scenario (data/disparity_synth, seed 7) with fresh
measurement noise per run; each run is one whole-run scan. Scores:
  - per-step camera position error vs the ground-truth trajectory
  - per-step OSPA(p=1, c=1) of the MAP particle's 3-D feature means vs
    the 30 shipped landmarks (ospa_np is dimension-agnostic)

Writes results/disparity_envelopes.png + a results/round3_evidence.json
entry.

Usage: python \
           scripts/disparity_evidence.py [--quick]
"""

from __future__ import annotations

import json
import os
import sys
import time


import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

QUICK = "--quick" in sys.argv


def main():
    import jax
    import jax.numpy as jnp

    from phdslam_tpu.config import load_config
    from phdslam_tpu.filter.disparity import DisparityState, \
        run_disparity_scan
    from phdslam_tpu.io.loaders import MeasurementSet, pad_measurement_sets
    from phdslam_tpu.ops.ospa import ospa_np
    from phdslam_tpu.simdata import (generate_disparity_run,
                                     make_disparity_scenario)
    from phdslam_tpu.utils import configure_compile_cache

    configure_compile_cache()
    cfg = load_config("cfg/disparity_synth.cfg")
    sc = make_disparity_scenario(np.random.default_rng(7), n_landmarks=30,
                                 n_steps=100)   # == shipped dataset seed
    T = sc.traj.shape[0] if not QUICK else 30
    n_runs = 2 if QUICK else 10
    if cfg.nSteps > 0:
        T = min(T, cfg.nSteps)

    pose_err = np.zeros((n_runs, T))
    ospa = np.full((n_runs, T), np.nan)
    card_est = np.zeros((n_runs, T))
    ms_per_step = []
    stride = 2
    for run in range(n_runs):
        rng = np.random.default_rng(100 + run)
        meas = generate_disparity_run(rng, sc)
        sets = [MeasurementSet(
            ranges=np.asarray(z, np.float32).reshape(-1, 2)[:, 0],
            bearings=np.asarray(z, np.float32).reshape(-1, 2)[:, 1],
            labels=np.zeros(np.asarray(z).reshape(-1, 2).shape[0],
                            np.int32)) for z in meas]
        rb, _, valid = pad_measurement_sets(sets, cfg.maxMeasurements)
        state = DisparityState.create(cfg)
        key = jax.random.PRNGKey(run)
        key, k0 = jax.random.split(key)
        jitter = jax.random.uniform(k0, (cfg.n_particles, 2),
                                    minval=-0.03, maxval=0.03)
        state = state.replace(pose=state.pose.at[:, 3].add(jitter[:, 0])
                              .at[:, 5].add(jitter[:, 1]))
        t0 = time.time()
        final, (auxs, _plog, (map_w, map_mean, _mc)) = run_disparity_scan(
            state, key, jnp.asarray(rb[:T]), jnp.asarray(valid[:T]),
            cfg, T, with_map_log=True)
        poses = np.asarray(auxs.expected_pose)          # sync
        elapsed = time.time() - t0
        ms_per_step.append(elapsed / T * 1000)
        map_w = np.asarray(map_w)
        map_mean = np.asarray(map_mean)
        pose_err[run] = np.linalg.norm(
            poses[:T, :3] - sc.traj[:T, :3], axis=1)
        card_est[run] = map_w.sum(-1)[:T]
        for t in range(0, T, stride):
            w = map_w[t]
            n_est = int(round(float(w.sum())))
            sel = np.argsort(-w)[: max(n_est, 0)]
            ospa[run, t] = ospa_np(sc.landmarks, map_mean[t][sel],
                                   p=1.0, c=1.0)[0]
        print(f"run {run}: pose mean {pose_err[run].mean():.3f} m, "
              f"final {pose_err[run, -1]:.3f} m, "
              f"final OSPA {ospa[run][np.isfinite(ospa[run])][-1]:.3f}, "
              f"{ms_per_step[-1]:.1f} ms/step", flush=True)

    # ---- envelope plot ----
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(3, 1, figsize=(8, 9))
    ts = np.arange(T)
    m, s = pose_err.mean(0), pose_err.std(0)
    axes[0].plot(ts, m)
    axes[0].fill_between(ts, m - s, m + s, alpha=0.25)
    axes[0].set_ylabel("camera position err [m]")
    with np.errstate(invalid="ignore"):
        om, os_ = np.nanmean(ospa, 0), np.nanstd(ospa, 0)
    ok = np.isfinite(om)
    axes[1].plot(ts[ok], om[ok])
    axes[1].fill_between(ts[ok], (om - os_)[ok], (om + os_)[ok], alpha=0.25)
    axes[1].set_ylabel("3-D map OSPA(p=1,c=1)")
    cm, cs = card_est.mean(0), card_est.std(0)
    axes[2].plot(ts, cm, label="est. cardinality (MAP particle)")
    axes[2].fill_between(ts, cm - cs, cm + cs, alpha=0.25)
    axes[2].axhline(sc.landmarks.shape[0], ls="--", c="k",
                    label="true landmarks")
    axes[2].set_ylabel("map cardinality")
    axes[2].set_xlabel("time step")
    axes[2].legend()
    fig.tight_layout()
    os.makedirs("results", exist_ok=True)
    fig.savefig("results/disparity_envelopes.png", dpi=110)

    out = dict(disparity=dict(
        n_runs=n_runs, steps=T,
        pose_mean=round(float(pose_err.mean()), 3),
        pose_final_mean=round(float(pose_err[:, -1].mean()), 3),
        pose_final_std=round(float(pose_err[:, -1].std()), 3),
        ospa_late_mean=round(float(np.nanmean(ospa[:, T // 2:])), 3),
        ospa_final_mean=round(float(np.nanmean(
            ospa[:, [t for t in range(0, T, stride)][-1]])), 3),
        card_final_mean=round(float(card_est[:, -1].mean()), 2),
        n_landmarks=int(sc.landmarks.shape[0]),
        # run 0 pays the scan compile; warm runs are the throughput number
        ms_per_step=round(float(np.mean(ms_per_step[1:])), 2)
        if len(ms_per_step) > 1 else round(float(ms_per_step[0]), 2),
        ms_per_step_cold=round(float(ms_per_step[0]), 2)))
    path = "results/round3_evidence.json"
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    data.update(out)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    print(json.dumps(out))


def oracle_phase():
    """Independent-anchor comparison: the dynamic-shape CPU disparity
    oracle (reference_cpu_disparity) vs the JAX path on the SHIPPED
    dataset — statistical parity (camera error, cardinality) + the honest
    CPU ms/step denominator for the disparity RESULTS row."""
    import jax
    import jax.numpy as jnp

    from phdslam_tpu import reference_cpu_disparity as RD
    from phdslam_tpu.config import load_config
    from phdslam_tpu.filter.disparity import DisparityState, \
        run_disparity_scan
    from phdslam_tpu.io.loaders import load_measurements, \
        pad_measurement_sets
    from phdslam_tpu.utils import configure_compile_cache

    configure_compile_cache()
    cfg = load_config("cfg/disparity_synth.cfg")
    sets = load_measurements("data/disparity_synth/measurements.txt")
    truth = np.loadtxt("data/disparity_synth/traj.txt", comments="%")
    T = 30 if QUICK else len(sets)
    meas = [np.stack([s.ranges, s.bearings], 1) for s in sets[:T]]

    cfg_cpu = cfg.replace(n_particles=16)
    cards = []
    t0 = time.time()
    poses_cpu = RD.run(cfg_cpu, meas, seed=1,
                       callback=lambda t, ps: cards.append(
                           ps[int(np.argmax([p.log_weight for p in ps]))]
                           .w.sum()))
    cpu_ms = (time.time() - t0) / T * 1000
    cpu_err = np.linalg.norm(poses_cpu[:, :3] - truth[:T, :3], axis=1)

    rb, _, valid = pad_measurement_sets(sets, cfg.maxMeasurements)
    state = DisparityState.create(cfg)
    key = jax.random.PRNGKey(1)
    key, k0 = jax.random.split(key)
    jitter = jax.random.uniform(k0, (cfg.n_particles, 2),
                                minval=-0.03, maxval=0.03)
    state = state.replace(pose=state.pose.at[:, 3].add(jitter[:, 0])
                          .at[:, 5].add(jitter[:, 1]))
    final, (auxs, _plog, (map_w, _mm, _mc)) = run_disparity_scan(
        state, key, jnp.asarray(rb[:T]), jnp.asarray(valid[:T]), cfg, T,
        with_map_log=True)
    poses_engine = np.asarray(auxs.expected_pose)
    engine_err = np.linalg.norm(poses_engine[:, :3] - truth[:T, :3], axis=1)

    out = dict(disparity_cpu_oracle=dict(
        n_particles_cpu=cfg_cpu.n_particles, steps=T,
        cpu_ms_per_step=round(cpu_ms, 1),
        cpu_pose_mean=round(float(cpu_err.mean()), 3),
        cpu_pose_final=round(float(cpu_err[-1]), 3),
        cpu_card_final=round(float(cards[-1]), 2),
        engine_pose_mean=round(float(engine_err.mean()), 3),
        engine_pose_final=round(float(engine_err[-1]), 3),
        engine_card_final=round(float(np.asarray(map_w)[-1].sum()), 2)))
    path = "results/round3_evidence.json"
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    data.update(out)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    if "--oracle" in sys.argv:
        oracle_phase()
    else:
        main()
