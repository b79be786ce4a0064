"""Version / runtime info (reference ``beat/info.py``)."""

from __future__ import annotations

version = "0.2.0"


def runtime_info() -> str:
    """Human-readable framework + backend summary (``beat-tpu --version``)."""
    lines = [f"beat_tpu {version} — Bayesian earthquake-source inversion"]
    try:
        import jax

        lines.append(f"jax {jax.__version__}")
        devs = jax.devices()
        lines.append(f"{len(devs)} device(s): "
                     + ", ".join(str(d) for d in devs[:8])
                     + (" …" if len(devs) > 8 else ""))
    except Exception as e:  # backend init can fail off-accelerator
        lines.append(f"jax backend unavailable ({e})")
    return "\n".join(lines)
