"""Multi-device sharding: the particle-axis data-parallel path must compile,
execute, normalize weights globally, and agree with the single-device step.
Runs on the conftest's 8-virtual-CPU-device backend."""

import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from phdslam_tpu.filter.state import Measurements, SlamState
from phdslam_tpu.filter.step import slam_step
from phdslam_tpu.parallel.mesh import (
    make_mesh,
    replicate_measurements,
    shard_state,
    sharded_step,
    state_shardings,
)
from phdslam_tpu.utils import REPO_ROOT

DISP_CFG = os.path.join(REPO_ROOT, "cfg", "disparity_synth.cfg")



pytestmark = pytest.mark.slow  # heavy e2e/interpret tests; unit core excludes via -m 'not slow'

@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, jax.devices()
    return make_mesh(8)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    m = cfg.maxMeasurements
    k = m // 2
    rb = np.zeros((m, 2), np.float32)
    rb[:k, 0] = rng.uniform(1.0, cfg.maxRange, k)
    rb[:k, 1] = rng.uniform(-1.0, 1.0, k)
    valid = np.zeros(m, bool)
    valid[:k] = True
    z = Measurements(rb=jnp.asarray(rb), label=jnp.zeros((m,), jnp.int32),
                     valid=jnp.asarray(valid))
    return z


def test_sharded_step_runs_and_normalizes(tiny_cfg, mesh):
    cfg = tiny_cfg.replace(n_particles=32)
    state = shard_state(SlamState.create(cfg), mesh)
    z = replicate_measurements(_inputs(cfg), mesh)
    step = sharded_step(cfg, mesh)
    key = jax.random.PRNGKey(0)
    for t in range(3):
        key, sk = jax.random.split(key)
        state, aux = step(state, sk, (jnp.float32(1.0), jnp.float32(0.05)),
                          z, jnp.float32(1.0), jnp.asarray(t > 0))
    total = float(jnp.sum(jnp.exp(state.log_weights)))
    assert abs(total - 1.0) < 1e-3
    assert np.isfinite(float(aux.neff))
    # state stays sharded over the particle axis
    shard = state.log_weights.sharding
    assert len(shard.device_set) == 8


def test_sharded_matches_single_device(tiny_cfg, mesh):
    """Same inputs + same PRNG key: the sharded step must produce the same
    numbers as the unsharded step (sharding is an implementation detail)."""
    cfg = tiny_cfg.replace(n_particles=32)
    z = _inputs(cfg)
    key = jax.random.PRNGKey(3)

    s_single = SlamState.create(cfg)
    s_single, aux1 = slam_step(
        s_single, key, (jnp.float32(1.0), jnp.float32(0.05)), z,
        jnp.float32(1.0), jnp.asarray(False), cfg)

    s_shard = shard_state(SlamState.create(cfg), mesh)
    zr = replicate_measurements(z, mesh)
    step = sharded_step(cfg, mesh)
    s_shard, aux2 = step(s_shard, key, (jnp.float32(1.0), jnp.float32(0.05)),
                         zr, jnp.float32(1.0), jnp.asarray(False))

    np.testing.assert_allclose(np.asarray(aux1.expected_pose),
                               np.asarray(aux2.expected_pose),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_single.log_weights),
                               np.asarray(s_shard.log_weights),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_single.map_static.w),
                               np.asarray(s_shard.map_static.w),
                               rtol=1e-3, atol=1e-5)


def test_sharded_cphd_matches_single_device(tiny_cfg, mesh):
    """CPHD under the same particle-axis sharding: the cardinality pmf
    ([P, Nmax+1]) shards like any per-particle state and the Psi inner
    products are per-particle, so sharded == single-device must hold for
    filterType=1 too (the dryrun's CPHD leg, __graft_entry__.py)."""
    cfg = tiny_cfg.replace(n_particles=32, filterType=1,
                           maxCardinality=16)
    z = _inputs(cfg)
    key = jax.random.PRNGKey(5)

    s_single = SlamState.create(cfg)
    s_single, aux1 = slam_step(
        s_single, key, (jnp.float32(1.0), jnp.float32(0.05)), z,
        jnp.float32(1.0), jnp.asarray(False), cfg)

    s_shard = shard_state(SlamState.create(cfg), mesh)
    zr = replicate_measurements(z, mesh)
    s_shard, aux2 = sharded_step(cfg, mesh)(
        s_shard, key, (jnp.float32(1.0), jnp.float32(0.05)), zr,
        jnp.float32(1.0), jnp.asarray(False))

    np.testing.assert_allclose(np.asarray(aux1.expected_pose),
                               np.asarray(aux2.expected_pose),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_single.log_weights),
                               np.asarray(s_shard.log_weights),
                               rtol=1e-4, atol=1e-5)
    cn1 = np.asarray(s_single.cardinality)
    cn2 = np.asarray(s_shard.cardinality)
    assert not np.isnan(cn1).any() and not np.isnan(cn2).any()
    fin = np.isfinite(cn1)
    assert (fin == np.isfinite(cn2)).all()
    np.testing.assert_allclose(cn1[fin], cn2[fin], rtol=1e-4, atol=1e-5)


def test_sharded_disparity_matches_single_device(mesh):
    """The monocular SC-PHD pipeline under the same particle-axis sharding:
    every DisparityState leaf is per-particle (camera pose, feature
    weights, clouds), so sharded == single-device must hold here too."""
    from phdslam_tpu.config import load_config
    from phdslam_tpu.filter.disparity import DisparityState, disparity_step
    from phdslam_tpu.parallel.mesh import sharded_disparity_step

    cfg = load_config(DISP_CFG).replace(
        n_particles=16, maxFeatures=8, maxMeasurements=8,
        particlesPerFeature=32, birthWeight=1e-2, pd=0.95,
        minSeparation=16.0, ax=0.01, ay=0.01, az=0.01,
        aroll=0.001, apitch=0.001, ayaw=0.001, dt=0.1,
        particleWeighting=0, clutterRate=2.0)
    m = cfg.maxMeasurements
    z_uv = np.zeros((m, 2), np.float32)
    z_uv[:4, 0] = np.linspace(150, 450, 4)
    z_uv[:4, 1] = np.linspace(120, 380, 4)
    z_val = np.zeros(m, bool)
    z_val[:4] = True
    key = jax.random.PRNGKey(7)

    s_single = DisparityState.create(cfg)
    s_shard = jax.device_put(
        DisparityState.create(cfg), state_shardings(s_single, mesh))
    step = sharded_disparity_step(cfg, mesh)
    for t in range(2):
        key, sk = jax.random.split(key)
        s_single, aux1 = disparity_step(
            s_single, sk, jnp.asarray(z_uv), jnp.asarray(z_val),
            jnp.float32(cfg.dt), jnp.asarray(t > 0), cfg)
        s_shard, aux2 = step(
            s_shard, sk, jnp.asarray(z_uv), jnp.asarray(z_val),
            jnp.float32(cfg.dt), jnp.asarray(t > 0))

    assert len(s_shard.log_weights.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(aux1.expected_pose),
                               np.asarray(aux2.expected_pose),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_single.log_weights),
                               np.asarray(s_shard.log_weights),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_single.w),
                               np.asarray(s_shard.w),
                               rtol=1e-3, atol=1e-5)


def _export_step_for_cuda(cfg, mesh, pmesh):
    """Lower the sharded step for CUDA from this CPU host (cross-platform
    lowering) and return the StableHLO text."""
    state = SlamState.create(cfg)
    z = _inputs(cfg)
    st_shard = state_shardings(state, mesh)
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())

    def step(state, key, control, z, dt, do_predict):
        return slam_step(state, key, control, z, dt, do_predict, cfg,
                         pmesh=pmesh)

    jitted = jax.jit(step, in_shardings=(
        st_shard, rep, (rep, rep),
        jax.tree.map(lambda _: rep, Measurements(rb=0, label=0, valid=0)),
        rep, rep))
    return jitted.trace(
        state, jax.random.PRNGKey(0),
        (jnp.float32(1.0), jnp.float32(0.05)), z, jnp.float32(1.0),
        jnp.asarray(True)).lower(lowering_platforms=("cuda",)).as_text()


def _kernel_calls(mlir):
    """The call lines of the two kernel wrappers in lowered StableHLO."""
    return [line for line in mlir.splitlines()
            if re.search(r"call @(fused_update_select|greedy_merge_pallas)",
                         line)]


def test_sharded_step_kernels_lower_per_shard_for_cuda(tiny_cfg, mesh):
    """The sharded step with the kernels on lowers for a multi-device GPU
    mesh with both Triton kernels called inside the manual (shard_map)
    computation on per-shard operands. cfg.kernelPlatform names the GPU,
    as resolve_pallas does for a GPU mesh, so kernels.kernel_mode chooses
    the compiled kernels in this CPU process. Negative control: without
    the shard_map wrap the kernels see the global particle axis."""
    cfg = tiny_cfg.replace(n_particles=32, kernelPlatform="gpu")
    local = 32 // len(mesh.devices.ravel())
    mlir = _export_step_for_cuda(cfg, mesh, pmesh=mesh)
    assert mlir.count("__gpu$xla.gpu.triton") >= 2
    start = mlir.index("sdy.manual_computation")
    body = mlir[start:mlir.index("sdy.return", start)]
    calls = _kernel_calls(body)
    assert {re.search(r"@(\w+?)(_\d+)?\(", c).group(1) for c in calls} \
        == {"fused_update_select", "greedy_merge_pallas"}, calls
    assert calls == _kernel_calls(mlir), "kernel call outside the region"
    for line in calls:
        assert f"tensor<{local}x" in line and "tensor<32x" not in line, line

    unwrapped = _kernel_calls(_export_step_for_cuda(cfg, mesh, pmesh=None))
    assert unwrapped and all("tensor<32x" in c for c in unwrapped)


def test_sharded_step_pallas_interpret_matches_single_device(tiny_cfg,
                                                             mesh):
    """Execute the shard_map-wrapped kernel path on the virtual CPU mesh
    (interpret mode) and require bit-equivalence with the single-device
    step running the identical kernels (on four cards:
    chip_smoke.py --four)."""
    cfg = tiny_cfg.replace(n_particles=32, usePallas=True,
                           pallasInterpret=True)
    z = _inputs(cfg)
    key = jax.random.PRNGKey(11)

    s_single = SlamState.create(cfg)
    s_single, aux1 = slam_step(
        s_single, key, (jnp.float32(1.0), jnp.float32(0.05)), z,
        jnp.float32(1.0), jnp.asarray(False), cfg)

    s_shard = shard_state(SlamState.create(cfg), mesh)
    s_shard, aux2 = sharded_step(cfg, mesh)(
        s_shard, key, (jnp.float32(1.0), jnp.float32(0.05)),
        replicate_measurements(z, mesh), jnp.float32(1.0),
        jnp.asarray(False))

    assert len(s_shard.log_weights.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(aux1.expected_pose),
                               np.asarray(aux2.expected_pose),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(s_single.log_weights),
                               np.asarray(s_shard.log_weights),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(s_single.map_static.w),
                               np.asarray(s_shard.map_static.w),
                               rtol=1e-5, atol=1e-6)


def test_graft_dryrun():
    import __graft_entry__ as g
    g.dryrun_multichip(8)
