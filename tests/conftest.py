"""Test configuration: CPU backend with 8 virtual devices (for sharding
tests) and the persistent compilation cache of phdslam_tpu.utils (XLA's CPU
compiles are expensive; the cache makes re-runs fast)."""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np
import pytest

import jax

from phdslam_tpu.utils import configure_compile_cache

configure_compile_cache()
# The suite runs on the CPU. Where a process already holds the GPU backend
# (chip_smoke.py's gpu-tests phase) this changes nothing, and the tests
# marked `gpu` run on the card.
jax.config.update("jax_platforms", "cpu")


@pytest.fixture()
def gpu():
    """Skips the test unless JAX runs on a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")


@pytest.fixture(scope="session")
def tiny_cfg():
    """The one canonical tiny config — keep shapes identical across tests so
    each jit program compiles once per session (and hits the on-disk cache
    across sessions)."""
    from phdslam_tpu.config import load_config

    return load_config(os.path.join(ROOT, "cfg", "ackerman_synth.cfg")
                       ).replace(n_particles=8, maxFeatures=16,
                                 maxMeasurements=8, birthWeight=1e-3, y0=0.0)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
