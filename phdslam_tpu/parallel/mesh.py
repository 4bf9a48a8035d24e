"""Particle-axis sharding over a device mesh.

The reference is strictly single-GPU (SURVEY.md section 2.4); the distributed
axis is new in this rebuild. The natural data-parallel axis of RBPF SLAM is
the particle index: every per-particle quantity (pose, map, weight) shards
over the mesh, measurements and config replicate, and only three global
reductions cross devices each step:

  1. logsumexp of particle log-weights (weight normalization,
     the distributed analog of src/phdfilter.cu:3749-3755) -> all-reduce
  2. nEff + the expected pose (weighted means) -> all-reduce
  3. resampling: stratified index computation needs the global cumulative
     weight vector (tiny: one scalar per particle -> all-gather), while the
     subsequent particle gather moves whole maps across devices. XLA lowers
     the jnp.take into the needed collective ops. The locality-preserving
     alternative (per-island local resampling + butterfly ppermute weight
     exchange) is implemented in parallel/island.py.

Everything runs through the same `slam_step` used on one card — sharding
is expressed entirely with NamedSharding annotations, XLA inserts
collectives — EXCEPT the measurement update when the kernels are on, which
`slam_step` then runs under `shard_map` over this mesh (`pmesh`,
filter.step._pshard): GSPMD cannot propagate a partitioning through a
`pallas_call`'s opaque custom call, so the kernels run inside a manual
(per-shard) computation. The update is RNG-free and per-particle
independent, so the manual region is bit-identical to the GSPMD form;
prediction, weight normalization, and the global resample stay in
GSPMD-land where XLA's collective insertion handles them.

Whether the kernels run follows the mesh's platform through
kernels.kernel_mode: compiled on a GPU mesh; on a CPU mesh the XLA update
path, or interpret mode when cfg.pallasInterpret asks — that is how the
virtual-CPU-mesh dryrun exercises the same shard_map-wrapped kernel path a
GPU mesh runs compiled. The mesh is 1-D over the particle axis: the cards
of one host are joined all to all, so no torus shape is needed.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from phdslam_tpu.filter.state import Measurements, SlamState

PARTICLE_AXIS = "particles"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """A 1-D particle-axis mesh over the first n_devices default-backend
    devices (all of them when None). Raises when too few exist."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"requested a {n_devices}-device mesh but only {len(devs)} "
                "devices exist; set jax.config.update('jax_num_cpu_devices', "
                f"{n_devices}) (or XLA_FLAGS=--xla_force_host_platform_"
                f"device_count={n_devices}) before initializing jax")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (PARTICLE_AXIS,))


def particle_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(PARTICLE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def state_shardings(state: SlamState, mesh: Mesh):
    """A SlamState pytree of shardings: every leaf shards on its leading
    (particle) axis."""
    shard = particle_sharding(mesh)

    def spec(leaf):
        ndim = np.ndim(leaf)
        return NamedSharding(mesh, P(PARTICLE_AXIS, *([None] * (ndim - 1))))

    return jax.tree.map(spec, state)


def shard_state(state: SlamState, mesh: Mesh) -> SlamState:
    """Place a SlamState across the mesh, particle axis sharded."""
    return jax.device_put(state, state_shardings(state, mesh))


def replicate_measurements(z: Measurements, mesh: Mesh) -> Measurements:
    return jax.device_put(z, replicated(mesh))


def resolve_pallas(cfg, mesh: Mesh):
    """Resolve (cfg, pmesh) for a sharded entry point from the mesh's
    platform (kernels.kernel_mode): kernels on -> the update runs under
    shard_map (pmesh=mesh) so the kernel calls run per shard, and the cfg
    carries the mesh's platform (cfg.kernelPlatform) so the update's own
    kernel_mode calls decide the same way whatever the process default
    backend; kernels off -> usePallas=False and the XLA update path, which
    GSPMD shards."""
    from phdslam_tpu.kernels import kernel_mode

    platform = mesh.devices.flat[0].platform
    use_kernel, _ = kernel_mode(cfg, platform)
    if not use_kernel:
        return cfg.replace(usePallas=False), None
    return cfg.replace(kernelPlatform=platform), mesh


def sharded_run_scan(cfg, mesh: Mesh, with_log_state: bool = False):
    """Whole-dataset `lax.scan` with the particle axis sharded over the
    mesh — the global-resample analog of parallel.island.island_run_scan
    (one dispatch for the full run; the honest form for throughput
    numbers, since loop-mode dispatch latency is excluded just as the
    reference's loopTime.log measures the in-loop GPU time,
    src/main.cpp:1300-1305).

    Semantics are identical to filter.step.run_scan (it IS run_scan,
    jitted with NamedSharding-pinned inputs/outputs): weight
    normalization and nEff lower to all-reduces, the stratified global
    resample's particle gather crosses devices, XLA inserts the
    collectives.

    Returns run(state, key, controls [T,2], zs (leading T), dts [T]) ->
    (final_state, stacked StepAux[, stacked LogAux]).
    """
    from phdslam_tpu.filter.step import run_scan

    rep = replicated(mesh)
    cfg, pmesh = resolve_pallas(cfg, mesh)

    dummy = SlamState.create(cfg)
    st_shard = state_shardings(dummy, mesh)
    z_rep = jax.tree.map(lambda _: rep, Measurements(rb=0, label=0, valid=0))

    def run(state, key, controls, zs, dts):
        return run_scan(state, key, controls, zs, dts, cfg,
                        controls.shape[0], with_log_state=with_log_state,
                        pmesh=pmesh)

    return jax.jit(
        run,
        in_shardings=(st_shard, rep, rep, z_rep, rep),
        donate_argnums=(0,),
    )


def sharded_disparity_step(cfg, mesh: Mesh):
    """Particle-axis-sharded disparity (monocular SC-PHD) step. The
    DisparityState pytree is per-particle on every leaf (camera pose,
    feature weights, particle clouds), so the same leading-axis sharding
    applies; weight normalization/nEff lower to all-reduces and the global
    stratified resample's cloud gather crosses devices, exactly as the
    2-D landmark path."""
    from phdslam_tpu.filter.disparity import DisparityState, disparity_step

    rep = replicated(mesh)
    cfg, pmesh = resolve_pallas(cfg, mesh)

    def step(state, key, z_uv, z_valid, dt, do_predict):
        return disparity_step(state, key, z_uv, z_valid, dt, do_predict,
                              cfg, pmesh=pmesh)

    dummy = DisparityState.create(cfg)
    st_shard = state_shardings(dummy, mesh)
    return jax.jit(
        step,
        in_shardings=(st_shard, rep, rep, rep, rep, rep),
        out_shardings=(st_shard, None),
        donate_argnums=(0,),
    )


def sharded_step(cfg, mesh: Mesh):
    """Return a jit-compiled slam_step whose state inputs/outputs are pinned
    to the particle sharding (donated to avoid copies on the big maps)."""
    from phdslam_tpu.filter.step import slam_step

    rep = replicated(mesh)
    # kernels follow the mesh's devices, not the process default backend
    cfg, pmesh = resolve_pallas(cfg, mesh)

    def step(state, key, control, z, dt, do_predict):
        return slam_step(state, key, control, z, dt, do_predict, cfg,
                         pmesh=pmesh)

    dummy = SlamState.create(cfg)
    st_shard = state_shardings(dummy, mesh)
    return jax.jit(
        step,
        in_shardings=(st_shard, rep, (rep, rep),
                      jax.tree.map(lambda _: rep, Measurements(
                          rb=0, label=0, valid=0)), rep, rep),
        out_shardings=(st_shard, None),
        donate_argnums=(0,),
    )
