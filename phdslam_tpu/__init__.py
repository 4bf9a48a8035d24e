"""phdslam_tpu — Rao-Blackwellized GM-PHD / CPHD SLAM on the GPU.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
cheesinglee/cuda-PHDSLAM. Each particle carries a vehicle pose plus a
Gaussian-mixture PHD map over landmarks; the whole SLAM step (pose
prediction, per-particle measurement update with birth terms, particle
weighting, mixture prune/merge, resampling) is one jit-compiled function
over fixed-size padded mixtures, with two Triton kernels (kernels/) for the
measurement select and the greedy merge, and sharded over a 1-D device mesh
on the particle axis when several cards are used.

Not a port: the reference's dynamic-shape machinery (thrust stream compaction,
host-side in/out-of-range splits, unbounded greedy merge) is replaced by
masks, top-k selection and bounded `lax.while_loop`s so the whole step stays
on-device under `jit`.
"""

import jax as _jax

# The SLAM math is small-matrix (2x2/4x4) float32 algebra. On the GPU a
# float32 dot_general may run in TF32, which keeps about three decimal
# digits (~2^-11 relative error) — enough to perturb Kalman covariances and
# merge decisions. These contractions are tiny, so full float32 precision
# costs nothing.
_jax.config.update("jax_default_matmul_precision", "highest")

from phdslam_tpu.config import SlamConfig, load_config
from phdslam_tpu.filter.state import (SlamState, GaussianMixture,
                                      Gaussian2DMixture)

__version__ = "0.1.0"

__all__ = [
    "SlamConfig",
    "load_config",
    "SlamState",
    "GaussianMixture",
    "Gaussian2DMixture",
]
