"""Application driver: the reference's main.cpp re-imagined.

CLI mirrors ``./bin/cuda-PHDSLAM <config.cfg> [synth|disparity] [profile]``
(src/main.cpp:1442-1500):

    python -m phdslam_tpu.runner <config.cfg> [synth] [profile] [options]

Per-step loop (src/main.cpp:1178-1312): timestamp-interleaved input
scheduling when *_times.txt files exist, lockstep otherwise; prediction is
skipped at step 0; measurement update only when the step has measurements;
stratified resampling on the nEff trigger; per-step state_estimate logs +
loopTime.log; a step-100 checkpoint enabling the 'profile' replay mode
(src/main.cpp:1262-1269, 1314-1321).

Two execution modes:
  - ``--mode loop``  (default): python loop over jit steps with host-side
    logging each step — like the reference, observable per step.
  - ``--mode scan``  : whole dataset as one on-device `lax.scan` — the
    benchmark path (logs written from stacked outputs afterwards).
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np

from phdslam_tpu.config import load_config, SlamConfig, CPHD_TYPE
from phdslam_tpu.filter.state import Measurements, SlamState
from phdslam_tpu.filter.step import run_scan, slam_step
from phdslam_tpu.filter import estimate
from phdslam_tpu.io import loaders, logs


def schedule_inputs(n_steps, meas_sets, controls, meas_times, ctrl_times):
    """Produce per-step (measurement_set_index, control_index, dt, do_z)
    following the timestamp interleave of src/main.cpp:1187-1237, or
    lockstep when no timestamps exist (measurement n with control n-1,
    src/main.cpp:1233-1234)."""
    sched = []
    if meas_times is None:
        for n in range(n_steps):
            sched.append(dict(z=n, c=n - 1 if n > 0 else None, dt=None,
                              predict=True))
        return sched
    z_idx, c_idx = 0, 0
    current_time = 0.0
    for n in range(n_steps):
        if z_idx >= len(meas_times) or c_idx >= len(ctrl_times):
            break
        if meas_times[z_idx] < ctrl_times[c_idx]:
            # measurement-only step: the reference keeps the previous
            # current_control and still predicts with it
            # (src/main.cpp:1193-1203) — reuse the last consumed control
            last, current_time = current_time, ctrl_times[c_idx]
            stale_c = c_idx - 1 if c_idx > 0 else None
            sched.append(dict(z=z_idx, c=stale_c, dt=current_time - last,
                              predict=True))
            z_idx += 1
        elif meas_times[z_idx] == ctrl_times[c_idx]:
            last, current_time = current_time, ctrl_times[c_idx]
            sched.append(dict(z=z_idx, c=c_idx, dt=current_time - last,
                              predict=True))
            z_idx += 1
            c_idx += 1
        else:
            last, current_time = current_time, ctrl_times[c_idx]
            sched.append(dict(z=None, c=c_idx, dt=current_time - last,
                              predict=True))
            c_idx += 1
    return sched


def _map_for_log(state, mixture, cfg, eap):
    """MAP (argmax-weight particle) or EAP (weighted concat + greedy reduce)
    estimate of one GM map, as numpy (w, mean, cov) with empty slots dropped
    (recoverSlamState, src/main.cpp:344-379)."""
    if eap:
        return estimate.eap_map_np(
            state.log_weights, mixture.w, mixture.mean, mixture.cov,
            cfg.minSeparation)
    idx = int(np.argmax(np.asarray(state.log_weights)))
    w = np.asarray(mixture.w[idx])
    valid = w > 0
    return (w[valid], np.asarray(mixture.mean[idx])[valid],
            np.asarray(mixture.cov[idx])[valid])


def _cn_estimate_for_log(state):
    """Cardinality distribution for log line 7: the MAP particle's under
    mapEstimate&1 (src/main.cpp:358-361; the reference's mapEstimate&2
    branch zeroes it via cn_estimate.clear(), :372-379 — we keep the MAP
    particle's, the only non-degenerate choice), particle 0 when there is
    only one particle (:385-387)."""
    if state.cardinality is None:
        return None
    lw = np.asarray(state.log_weights)
    idx = int(np.argmax(lw)) if lw.shape[0] > 1 else 0
    return np.asarray(state.cardinality[idx])


def _write_step_log(out_dir, t, state, aux, cfg, eap=False):
    eap = bool(cfg.mapEstimate & 2) or eap
    w, mean, cov = _map_for_log(state, state.map_static, cfg, eap)
    dyn_w = dyn_mean = dyn_cov = None
    if cfg.featureModel != 0 and state.map_dynamic.max_features > 0:
        # dynamic map is log line 3 (src/main.cpp:884-900)
        dyn_w, dyn_mean, dyn_cov = _map_for_log(
            state, state.map_dynamic, cfg, eap)
    repeat = cfg.nPredictParticles if t == 0 else 1
    logs.write_state_estimate_log(
        out_dir, t, np.asarray(aux.expected_pose),
        w, mean, cov,
        dynamic_w=dyn_w, dynamic_mean=dyn_mean, dynamic_cov=dyn_cov,
        particle_log_weights=np.asarray(state.log_weights),
        particle_poses=np.asarray(state.pose),
        resample_idx=np.asarray(state.resample_idx),
        cardinality=_cn_estimate_for_log(state),
        max_cardinality=cfg.maxCardinality,
        is_cphd=cfg.filterType == CPHD_TYPE,
        repeat=repeat)


def load_truth_maps(path):
    """Ground-truth landmark locations for in-loop OSPA scoring.

    Accepts the reference's simData .mat (per-step visited-landmark lists,
    sim.groundTruth[t].loc [2, L_t] — what python/batch_analyze.py:26-33
    scores against) or a plain text file of 'x y' lines (one static map
    used for every step). Returns a callable t -> [L, 2] array."""
    if path.endswith(".mat"):
        from scipy.io import loadmat
        sim = loadmat(path)["sim"][0, 0]
        gt = sim["groundTruth"]
        maps = [np.asarray(gt[0, t][0, 0]["loc"], np.float64).T
                for t in range(gt.shape[1])]
        return lambda t: maps[min(t, len(maps) - 1)]
    pts = np.loadtxt(path, ndmin=2, comments=("#", "%"))[:, :2]
    return lambda t: pts


def _ospa_from_map(w, mx, my, truth_maps, t, p=1.0, c=5.0):
    """OSPA of one estimated map vs truth, thresholded the batch_analyze
    way (top round(sum w) weights, python/batch_analyze.py:26-28)."""
    from phdslam_tpu.ops.ospa import ospa_np
    n_est = int(round(float(w.sum())))
    order = np.argsort(w)[::-1][:max(n_est, 0)]
    est = np.stack([mx[order], my[order]], axis=-1)
    o, loc, card = ospa_np(est, truth_maps(t), p=p, c=c)
    return [float(o), float(loc), float(card)]


def _step_ospa(state, truth_maps, t):
    """Per-step OSPA of the MAP-particle map vs truth."""
    idx = int(np.argmax(np.asarray(state.log_weights)))
    return _ospa_from_map(np.asarray(state.map_static.w[idx]),
                          np.asarray(state.map_static.mx[idx]),
                          np.asarray(state.map_static.my[idx]),
                          truth_maps, t)


def _unpack_cov_channels(ch):
    """[10, F] row-major upper-triangle channels -> [F, 4, 4] (the packing
    of Gaussian4DMixture, filter/state.py)."""
    f = ch.shape[-1]
    cov = np.zeros((f, 4, 4), ch.dtype)
    k = 0
    for i in range(4):
        for j in range(i, 4):
            cov[:, i, j] = ch[k]
            cov[:, j, i] = ch[k]
            k += 1
    return cov


def _write_scan_logs(out_dir, t_valid, auxs, log_auxs, cfg, ms_per_step,
                     truth_maps=None):
    """Write the per-step log contract (state_estimate logs +
    metrics.jsonl) from the stacked scan outputs, so --mode scan produces
    the same file set loop mode does. The map estimate is the MAP
    particle's (EAP would need every particle's map per step on the host)."""
    la = jax.device_get(log_auxs)
    poses = np.asarray(auxs.expected_pose)
    for t in range(t_valid):
        w = np.asarray(la.map_w[t])
        sel = w > 0
        mean = np.stack([np.asarray(la.map_mx[t])[sel],
                         np.asarray(la.map_my[t])[sel]], axis=-1)
        cov = np.zeros((sel.sum(), 2, 2), np.float32)
        cov[:, 0, 0] = np.asarray(la.map_c00[t])[sel]
        cov[:, 0, 1] = cov[:, 1, 0] = np.asarray(la.map_c01[t])[sel]
        cov[:, 1, 1] = np.asarray(la.map_c11[t])[sel]
        dyn_w = dyn_mean = dyn_cov = None
        if cfg.featureModel != 0 and la.dyn_w.shape[-1] > 0:
            dw = np.asarray(la.dyn_w[t])
            dsel = dw > 0
            dyn_w = dw[dsel]
            dyn_mean = np.asarray(la.dyn_mean[t]).T[dsel]
            dyn_cov = _unpack_cov_channels(np.asarray(la.dyn_cov[t]))[dsel]
        is_cphd = cfg.filterType == CPHD_TYPE
        logs.write_state_estimate_log(
            out_dir, t, poses[t],
            w[sel], mean, cov,
            dynamic_w=dyn_w, dynamic_mean=dyn_mean, dynamic_cov=dyn_cov,
            particle_log_weights=np.asarray(la.log_weights[t]),
            particle_poses=np.asarray(la.poses[t]),
            resample_idx=np.asarray(la.resample_idx[t]),
            cardinality=np.asarray(la.cardinality[t]) if is_cphd else None,
            max_cardinality=cfg.maxCardinality,
            is_cphd=is_cphd,
            repeat=cfg.nPredictParticles if t == 0 else 1)
        metrics = dict(
            t=t, ms=ms_per_step, neff=float(np.asarray(auxs.neff[t])),
            n_measure=int(np.asarray(auxs.n_measure[t])),
            resampled=bool(np.asarray(auxs.resampled[t])),
            log_lik=float(np.asarray(auxs.log_lik[t])),
            card=float(w.sum()))
        if truth_maps is not None:
            metrics["ospa"] = _ospa_from_map(
                w, np.asarray(la.map_mx[t]), np.asarray(la.map_my[t]),
                truth_maps, t)
        logs.append_metrics_jsonl(out_dir, metrics)


def _write_island_scan_logs(out_dir, t_valid, auxs, la, cfg, ms_per_step,
                            truth_maps=None):
    """Log contract for island scan mode: the map line is the globally best
    particle's map (argmax over islands of island_logw + local max lw);
    weights/poses/resample lines carry all P particles (global log weights
    = island + local)."""
    la = jax.device_get(la)
    poses = np.asarray(auxs.expected_pose)
    for t in range(t_valid):
        isl = int(np.argmax(np.asarray(la.best_score[t])))
        w = np.asarray(la.best_w[t][isl])
        sel = w > 0
        mean = np.stack([np.asarray(la.best_mx[t][isl])[sel],
                         np.asarray(la.best_my[t][isl])[sel]], axis=-1)
        cov = np.zeros((sel.sum(), 2, 2), np.float32)
        cov[:, 0, 0] = np.asarray(la.best_c00[t][isl])[sel]
        cov[:, 0, 1] = cov[:, 1, 0] = np.asarray(la.best_c01[t][isl])[sel]
        cov[:, 1, 1] = np.asarray(la.best_c11[t][isl])[sel]
        logs.write_state_estimate_log(
            out_dir, t, poses[t], w[sel], mean, cov,
            particle_log_weights=np.asarray(la.log_weights[t]),
            particle_poses=np.asarray(la.poses[t]),
            resample_idx=np.asarray(la.resample_idx[t]),
            max_cardinality=cfg.maxCardinality,
            repeat=cfg.nPredictParticles if t == 0 else 1)
        metrics = dict(
            t=t, ms=ms_per_step,
            neff=float(np.asarray(auxs.island_neff[t])),
            exchanged=bool(np.asarray(auxs.exchanged[t])),
            log_lik=float(np.asarray(auxs.log_lik[t])),
            card=float(w.sum()))
        if truth_maps is not None:
            metrics["ospa"] = _ospa_from_map(
                w, np.asarray(la.best_mx[t][isl]),
                np.asarray(la.best_my[t][isl]), truth_maps, t)
        logs.append_metrics_jsonl(out_dir, metrics)


def run_synth(cfg: SlamConfig, args) -> dict:
    data_dir = args.data_dir or cfg.dataDirectory
    meas_path = args.measurements or os.path.join(data_dir,
                                                  "measurements.txt")
    ctrl_path = args.controls or os.path.join(data_dir, "controls.txt")
    meas_sets = loaders.load_measurements(meas_path,
                                          labeled=cfg.labeledMeasurements)
    controls = loaders.load_controls(ctrl_path)
    meas_times = loaders.load_timestamps(
        os.path.join(data_dir, "measurement_times.txt"))
    ctrl_times = loaders.load_timestamps(
        os.path.join(data_dir, "control_times.txt"))

    traj = None
    if cfg.followTrajectory:
        # follow a preset trajectory with a single particle
        # (src/main.cpp:1121-1127, 1239-1243)
        traj = loaders.load_trajectory(os.path.join(data_dir, "traj.txt"))
        cfg = cfg.replace(n_particles=1)

    n_steps = len(meas_sets)
    if meas_times is not None:
        n_steps = len(meas_times) + len(ctrl_times)
    if cfg.nSteps > 0:
        n_steps = min(n_steps, cfg.nSteps)
    n_steps = min(n_steps, cfg.maxSteps)

    rb, labels, valid = loaders.pad_measurement_sets(
        meas_sets, cfg.maxMeasurements)

    out_dir = args.out_dir
    os.makedirs(out_dir, exist_ok=True)
    truth_maps = (load_truth_maps(args.truth)
                  if getattr(args, "truth", None) else None)
    if cfg.debug:
        # the cuPrintf / DEBUG_MSG analog (SURVEY.md section 5.2): locate
        # the first NaN-producing primitive instead of propagating it
        jax.config.update("jax_debug_nans", True)
    state = SlamState.create(cfg)
    key = jax.random.PRNGKey(args.seed)

    sched = schedule_inputs(n_steps, meas_sets, controls, meas_times,
                            ctrl_times)

    if args.mode == "scan":
        t_len = len(sched)
        ctrl_arr = np.zeros((t_len, 2), np.float32)
        dt_arr = np.full((t_len,), cfg.dt, np.float32)
        z_rb = np.zeros((t_len, cfg.maxMeasurements, 2), np.float32)
        z_lab = np.zeros((t_len, cfg.maxMeasurements), np.int32)
        z_val = np.zeros((t_len, cfg.maxMeasurements), bool)
        for i, s in enumerate(sched):
            if s["c"] is not None and s["c"] >= 0:
                ctrl_arr[i] = controls[s["c"]]
            if s["dt"] is not None:
                dt_arr[i] = s["dt"]
            if s["z"] is not None:
                z_rb[i] = rb[s["z"]]
                z_lab[i] = labels[s["z"]]
                z_val[i] = valid[s["z"]]
        zs = Measurements(rb=jnp.asarray(z_rb), label=jnp.asarray(z_lab),
                          valid=jnp.asarray(z_val))
        log_auxs = None
        island_log_auxs = None
        if getattr(args, "islands", 0) and args.islands > 1:
            from phdslam_tpu.parallel.island import (island_run_scan,
                                                     make_island_mesh)
            imesh = make_island_mesh(args.islands)
            irun, iinit = island_run_scan(imesh, cfg,
                                          with_log_state=not args.no_logs)
            istate, ilw = iinit()
            t0 = time.time()
            out = irun(istate, ilw, key, jnp.asarray(ctrl_arr), zs,
                       jnp.asarray(dt_arr))
            if not args.no_logs:
                final, ilw, auxs, island_log_auxs = out
            else:
                final, ilw, auxs = out
            jax.block_until_ready(out)
            elapsed = time.time() - t0
            poses = np.asarray(auxs.expected_pose)
            neffs = np.asarray(auxs.island_neff)
        else:
            t0 = time.time()
            final, auxs = run_scan(state, key, jnp.asarray(ctrl_arr), zs,
                                   jnp.asarray(dt_arr), cfg, t_len,
                                   with_log_state=not args.no_logs)
            jax.block_until_ready((final, auxs))
            elapsed = time.time() - t0
            if not args.no_logs:
                auxs, log_auxs = auxs
            poses = np.asarray(auxs.expected_pose)
            neffs = np.asarray(auxs.neff)
        # NaN abort (src/main.cpp:1307-1311): a scan can't stop mid-run,
        # but flag the first NaN step and truncate the outputs there
        nan_steps = np.flatnonzero(~np.isfinite(neffs))
        t_valid = int(nan_steps[0]) if nan_steps.size else t_len
        if t_valid < t_len:
            print(f"nan weights detected at step {t_valid}! "
                  "truncating outputs...")
        for t in range(t_valid):
            logs.append_loop_time(out_dir, elapsed / t_len * 1000)
        if log_auxs is not None:
            _write_scan_logs(out_dir, t_valid, auxs, log_auxs, cfg,
                             elapsed / t_len * 1000, truth_maps)
        elif island_log_auxs is not None:
            _write_island_scan_logs(out_dir, t_valid, auxs,
                                    island_log_auxs, cfg,
                                    elapsed / t_len * 1000, truth_maps)
        print(f"scan: {t_len} steps in {elapsed:.3f}s "
              f"({elapsed / t_len * 1000:.2f} ms/step)")
        return dict(state=final, poses=poses, aux=auxs,
                    ms_per_step=elapsed / t_len * 1000,
                    nan_step=t_valid if t_valid < t_len else None)

    # ---- loop mode ----
    use_islands = getattr(args, "islands", 0) and args.islands > 1
    if use_islands:
        from phdslam_tpu.parallel.island import (island_slam_step,
                                                 make_island_mesh)
        imesh = make_island_mesh(args.islands)
        island_step, island_init = island_slam_step(imesh, cfg)
        state, island_logw = island_init()
        print(f"island mode: {args.islands} islands x "
              f"{cfg.n_particles // args.islands} particles")
    poses_out = []
    z_prev = None
    start_t = 0
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    if args.resume:
        from phdslam_tpu import checkpoint as ckpt
        latest = ckpt.latest_checkpoint(ckpt_dir)
        if latest:
            state, key, start_t = ckpt.restore_checkpoint(latest)
            start_t += 1
            print(f"resumed from {latest} at step {start_t}")
    for t, s in enumerate(sched):
        if t < start_t:
            continue
        t0 = time.time()
        if s["z"] is not None:
            z = Measurements(rb=jnp.asarray(rb[s["z"]]),
                             label=jnp.asarray(labels[s["z"]]),
                             valid=jnp.asarray(valid[s["z"]]))
        else:
            z = Measurements(
                rb=jnp.zeros((cfg.maxMeasurements, 2), jnp.float32),
                label=jnp.zeros((cfg.maxMeasurements,), jnp.int32),
                valid=jnp.zeros((cfg.maxMeasurements,), bool))
        ctrl = (jnp.float32(controls[s["c"], 0]) if s["c"] is not None
                else jnp.float32(0),
                jnp.float32(controls[s["c"], 1]) if s["c"] is not None
                else jnp.float32(0))
        dt = jnp.float32(s["dt"] if s["dt"] is not None else cfg.dt)
        key, sk = jax.random.split(key)
        do_predict = t > 0 and s["predict"]
        if traj is not None and t < len(traj):
            state = state.replace(pose=jnp.broadcast_to(
                jnp.asarray(traj[t]), state.pose.shape))
            do_predict = False

        if cfg.savePrediction:
            # dump the predicted (pre-update) particles, exactly as the
            # update will consume them (src/main.cpp:1256-1257)
            from phdslam_tpu.filter.step import predicted_state
            from phdslam_tpu.io.matdump import write_particles_mat
            pred = predicted_state(state, sk, ctrl, dt,
                                   jnp.asarray(do_predict), cfg)
            write_particles_mat(out_dir, t, jax.device_get(pred),
                                prefix="particles_predict")

        if t == 100 and args.checkpoint:
            with open(os.path.join(out_dir, "state100.pkl"), "wb") as f:
                pickle.dump(dict(state=jax.device_get(state),
                                 z=jax.device_get(z)), f)

        if args.predict_time and do_predict:
            from phdslam_tpu.filter.predict import predict as _predict
            import jax as _jax
            _pt0 = time.time()
            _pred = _jax.jit(_predict, static_argnames=("cfg",))(
                sk, state, ctrl, cfg, dt)
            _jax.block_until_ready(_pred)
            logs.append_predict_time(out_dir, (time.time() - _pt0) * 1000)
        if use_islands:
            from phdslam_tpu.filter.step import StepAux
            state, island_logw, iaux = island_step(
                state, island_logw, sk, jnp.stack(ctrl), z, dt,
                jnp.asarray(do_predict), z_prev=z_prev)
            aux = StepAux(expected_pose=iaux.expected_pose,
                          neff=iaux.island_neff,
                          resampled=iaux.exchanged,
                          n_measure=z.count, log_lik=iaux.log_lik)
        else:
            state, aux = slam_step(state, sk, ctrl, z, dt,
                                   jnp.asarray(do_predict), cfg,
                                   with_variance=args.variance,
                                   z_prev=z_prev)
        z_prev = z
        jax.block_until_ready(state)
        elapsed_ms = (time.time() - t0) * 1000
        neff_val = float(np.asarray(aux.neff))
        logs.append_loop_time(out_dir, elapsed_ms)
        if not args.no_logs:
            _write_step_log(out_dir, t, state, aux, cfg)
        metrics = dict(
            t=t, ms=elapsed_ms, neff=neff_val,
            n_measure=int(aux.n_measure),
            resampled=bool(aux.resampled),
            log_lik=float(aux.log_lik),
            card=float(np.asarray(state.map_static.w[
                int(np.argmax(np.asarray(state.log_weights)))]).sum()))
        if truth_maps is not None:
            metrics["ospa"] = _step_ospa(state, truth_maps, t)
        logs.append_metrics_jsonl(out_dir, metrics)
        poses_out.append(np.asarray(aux.expected_pose))
        if args.checkpoint_every and t > 0 and t % args.checkpoint_every == 0:
            from phdslam_tpu import checkpoint as ckpt
            ckpt.save_checkpoint(ckpt_dir, t, state, key)
        if args.mat_export or cfg.saveAllMaps:
            from phdslam_tpu.io.matdump import write_particles_mat
            hstate = jax.device_get(state)
            has_dyn = (cfg.featureModel != 0
                       and state.map_dynamic.max_features > 0)
            est_maps = {}
            if cfg.mapEstimate & 1:  # MAP map (src/main.cpp:672-682)
                est_maps["max_map_static"] = _map_for_log(
                    hstate, hstate.map_static, cfg, eap=False)
                if has_dyn:
                    est_maps["max_map_dynamic"] = _map_for_log(
                        hstate, hstate.map_dynamic, cfg, eap=False)
            if cfg.mapEstimate & 2:  # EAP map (src/main.cpp:684-692)
                est_maps["exp_map_static"] = _map_for_log(
                    hstate, hstate.map_static, cfg, eap=True)
                if has_dyn:
                    est_maps["exp_map_dynamic"] = _map_for_log(
                        hstate, hstate.map_dynamic, cfg, eap=True)
            write_particles_mat(out_dir, t, hstate, **est_maps)
        if np.isnan(neff_val):
            print("nan weights detected! exiting...")
            break
        if args.verbose:
            print(f"step {t}/{len(sched)} ms={elapsed_ms:.1f} "
                  f"neff={float(aux.neff):.3f}")
    return dict(state=state, poses=np.asarray(poses_out))


def run_profile(cfg: SlamConfig, args):
    """Replay the step-100 fixture once — the reference's profile mode
    (src/main.cpp:1314-1321)."""
    with open(os.path.join(args.out_dir, "state100.pkl"), "rb") as f:
        d = pickle.load(f)
    state = jax.device_put(d["state"])
    z = jax.device_put(d["z"])
    key = jax.random.PRNGKey(args.seed)
    t0 = time.time()
    state1, aux = slam_step(state, key, (jnp.float32(0), jnp.float32(0)), z,
                            jnp.float32(cfg.dt), jnp.asarray(True), cfg)
    jax.block_until_ready(state1)
    print(f"profile step: {(time.time() - t0) * 1000:.2f} ms (incl compile)")
    t0 = time.time()
    state2, aux = slam_step(state, key, (jnp.float32(0), jnp.float32(0)), z,
                            jnp.float32(cfg.dt), jnp.asarray(True), cfg)
    jax.block_until_ready(state2)
    print(f"profile step: {(time.time() - t0) * 1000:.2f} ms (compiled)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config")
    ap.add_argument("run_type", nargs="?", default="synth",
                    choices=["synth", "disparity"])
    ap.add_argument("profile", nargs="?", default="",
                    help="pass 'profile' to replay the step-100 fixture")
    ap.add_argument("--mode", default="loop", choices=["loop", "scan"])
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--measurements", default=None)
    ap.add_argument("--controls", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-steps", type=int, default=0,
                    help="run at most this many steps (overrides the "
                         "cfg's n_steps)")
    ap.add_argument("--no-logs", action="store_true")
    ap.add_argument("--checkpoint", action="store_true", default=True)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="write a resumable checkpoint every K steps")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in out-dir")
    ap.add_argument("--mat-export", action="store_true",
                    help="write particlesXXXXX.mat each step "
                         "(save_all_maps equivalent)")
    ap.add_argument("--predict-time", action="store_true",
                    help="additionally time the prediction alone each step "
                         "-> predicttime.log (src/phdfilter.cu:1244-1251)")
    ap.add_argument("--variance", action="store_true",
                    help="compute the per-particle cardinality variance "
                         "each update (closed-form Mahler statistic; "
                         "deliberate deviation from the broken MC sampler "
                         "in phdVarianceKernel, src/phdfilter.cu:3585-3597 "
                         "— see filter/update.py::phd_variance). Exported "
                         "as particles.variances; scale differs from "
                         "reference logs.")
    ap.add_argument("--truth", default=None,
                    help="ground-truth landmarks (simData .mat or 'x y' "
                         "text) -> per-step OSPA column in metrics.jsonl")
    ap.add_argument("--islands", type=int, default=0,
                    help="run distributed over N mesh devices with "
                         "island-model (locality-preserving) resampling "
                         "(parallel/island.py); works in loop AND scan "
                         "modes, with PHD and CPHD filters")
    ap.add_argument("--player", action="store_true",
                    help="after the run, bundle the out-dir's logs into a "
                         "standalone interactive HTML player "
                         "(out-dir/player.html; eval/player.py)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    # persistent compilation cache: repeated runs (and scan-mode timing)
    # skip the one-time XLA compile
    from phdslam_tpu.utils import configure_compile_cache
    configure_compile_cache()

    cfg = load_config(args.config)
    if args.n_steps:
        cfg = cfg.replace(nSteps=args.n_steps)
    if args.run_type == "disparity":
        from phdslam_tpu.filter.disparity import run_disparity
        res = run_disparity(cfg, args)
    elif args.profile == "profile":
        res = run_profile(cfg, args)
    else:
        res = run_synth(cfg, args)
    if getattr(args, "player", False) and not args.no_logs:
        from phdslam_tpu.eval.player import build_player
        truth = args.truth if args.truth else (
            (args.data_dir or cfg.dataDirectory)
            if args.run_type == "disparity" else None)
        try:
            out = build_player(args.out_dir, truth_mat=truth)
            print(f"player: {out}")
        except FileNotFoundError as e:
            print(f"player skipped: {e}")
    return res


if __name__ == "__main__":
    main()
