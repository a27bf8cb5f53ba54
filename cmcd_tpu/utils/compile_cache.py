"""Persistent XLA compile cache at a fixed place.

The flagship steps take tens of seconds to compile. JAX keys its persistent
cache by directory, so the directory must not move between runs: either the
one `JAX_COMPILATION_CACHE_DIR` names (JAX reads that variable itself), or
`.jax_cache/` at the root of the checkout.
"""

from __future__ import annotations

import os

import jax

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir(environ=os.environ) -> str | None:
    """The directory this program sets, or None when the environment
    already names one for JAX."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CHECKOUT_CACHE_DIR


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compile cache at compile_cache_dir(). Call once
    at start-up, before the first compilation."""
    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
