"""
Physics core: forward models, datasets, tapers/filters, Green's-function
tables — the JAX re-design of the reference ``beat/heart.py``.
"""

from beat_tpu.heart.okada import okada_surface_displacement  # noqa: F401
