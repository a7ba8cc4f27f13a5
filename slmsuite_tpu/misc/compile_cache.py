"""
Persistent XLA compilation cache for the scripts at the repository root.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it and
nothing is set in code. Otherwise the cache lives at a fixed
``<root>/.jax_cache`` (listed in ``.gitignore``): the cache key includes
its path, so a directory that moves never hits.
"""

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache(root):
    """Point JAX's persistent compilation cache at ``<root>/.jax_cache``
    unless ``JAX_COMPILATION_CACHE_DIR`` is set. Returns the directory
    in use."""
    configured = os.environ.get(ENV_VAR)
    if configured:
        return configured
    import jax

    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
