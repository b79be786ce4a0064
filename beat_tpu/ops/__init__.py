"""
Compute kernels: eikonal rupture-front solver, Voronoi assignment and
real-pair complex arithmetic — plain JAX replacements of the
reference's C extensions and hot pytensor ops.
"""

from beat_tpu.ops.eikonal import eikonal_rupture_times, eikonal_rupture_times_numpy  # noqa: F401
from beat_tpu.ops.voronoi import nearest_voronoi_node, nearest_voronoi_node_numpy  # noqa: F401
