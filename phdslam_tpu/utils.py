"""Small runtime utilities."""

from __future__ import annotations

import dataclasses
import os

#: the checkout root: the directory that holds the phdslam_tpu package
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytree_dataclass(cls):
    """A frozen dataclass registered as a JAX pytree whose fields are all
    children, with ``.replace(**changes)``."""
    import jax

    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=names,
                                            meta_fields=[])


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives: the directory that
    JAX_COMPILATION_CACHE_DIR names when it is set, otherwise
    ``<checkout>/.jax_cache`` (listed in .gitignore). A fixed path, so
    repeated runs of one checkout hit the same cache."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir().
    When JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and nothing
    is set here. Returns the directory in use."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
