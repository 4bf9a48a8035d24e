"""Hand-written kernels for the hot ops, and the one place that decides
whether they run.

Both kernels are Pallas kernels on the Triton route (``backend="triton"``):
``preupdate_pallas.fused_update_select`` (the per-measurement normalizer
sums and top-k1 detection select) and ``merge_pallas.greedy_merge_pallas``
(the exact greedy mixture merge, one program per particle).
"""

from __future__ import annotations

import jax


def kernel_mode(cfg, platform: str | None = None) -> tuple[bool, bool]:
    """Return ``(use_kernel, interpret)`` for the Pallas kernels.

    ``platform`` is where the computation runs. When it is not given,
    ``cfg.kernelPlatform`` (set from a mesh's devices by
    ``parallel.mesh.resolve_pallas``) decides, else the process default
    backend.

      gpu                         -> the compiled kernel (cfg.usePallas)
      gpu + cfg.pallasInterpret   -> error: interpret mode never runs on
                                     the card by accident
      cpu                         -> the XLA path, or interpret mode when
                                     cfg.pallasInterpret asks (tests)
    """
    if not cfg.usePallas:
        return False, False
    platform = platform or cfg.kernelPlatform or jax.default_backend()
    if platform == "gpu":
        if cfg.pallasInterpret:
            raise ValueError(
                "pallas_interpret is a CPU test mode; it cannot run on "
                f"the {platform} backend")
        return True, False
    return (True, True) if cfg.pallasInterpret else (False, False)
