"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is the cache: nothing here
picks another directory. Otherwise the cache lives at the fixed path
``<checkout>/.jax_cache`` (listed in .gitignore) — fixed because the
directory is part of what makes a later process find the entries.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return that directory."""
    import jax

    d = compile_cache_dir()
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    return d
