"""
Test configuration: the CPU backend with 8 virtual devices, so the
multi-device sharding logic runs without accelerators (see also
``__graft_entry__.dryrun_multichip``).

Tests marked ``chip`` need the GPU and skip here; on a machine with a
card run them with the CUDA platform requested explicitly:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m chip tests/

Must run before the first ``import jax`` anywhere in the test session.
"""

import os
import sys

_ON_CARD = "cuda" in os.environ.get("JAX_PLATFORMS", "").split(",")
if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

# XLA compilation dominates test wall-clock — persist compiled
# executables across test runs (the library's default location too,
# beat_tpu.compile_cache.default_cache_dir).
_root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(_root, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

# repo-root modules (__graft_entry__, bench, chip_smoke, tools)
if _root not in sys.path:
    sys.path.insert(0, _root)

# a pytest plugin may have imported jax before this file set the
# environment — set the platform through the config API too
import jax  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu", "tests must run on the CPU backend"
