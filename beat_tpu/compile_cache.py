"""
Persistent XLA compilation cache for library users.

Compiling the sampler's step programs takes seconds per program, and
they recompile whenever the process (or the ``logp`` closure) is new.
The in-process jit cache is handled by :meth:`Problem.make_logp_fn`
caching its closure; this module covers the ACROSS-process axis:
compiled executables are serialized to disk keyed by their HLO hash, so
a rerun of the same inversion (resume, bench repetition, CLI
invocation) skips the compile.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR``, when it is set — JAX reads it itself
  and nothing here sets another directory;
* otherwise the fixed path ``<checkout>/.jax_cache`` (listed in
  ``.gitignore``; the test suite uses the same one), so every process
  of one checkout finds the same entries.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("beat_tpu.compile_cache")


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache`` — the directory above the package."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")


def enable_persistent_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at
    :func:`default_cache_dir` unless ``JAX_COMPILATION_CACHE_DIR`` or an
    earlier configuration already chose one.  Safe to call repeatedly,
    before or after backend initialization.  Returns the directory in
    use (``None`` when the default cannot be created)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    path = default_cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as e:   # read-only checkout: run without a disk cache
        logger.debug("persistent compile cache unavailable: %s", e)
        return None
    jax.config.update("jax_compilation_cache_dir", path)
    return path
