"""
Nearest-Voronoi-node assignment of fault patches.

The reference uses a brute-force O(N·M) C extension
(``beat/voronoi/voronoi_ext.c:59`` ``GetMinDistances``); on device this is
one argmin over a pairwise-distance matrix — a trivially fused XLA
computation that also ``vmap``s over chains of node positions
(trans-dimensional slip parameterisations, ``config.py:88``
``voronoi_locations``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def nearest_voronoi_node(node_strike, node_dip, patch_strike, patch_dip):
    """
    Index of the nearest Voronoi node for every patch.

    node_* : (M,) node coordinates on the fault plane [km]
    patch_* : (N,) patch-center coordinates

    Returns (N,) int32 indexes into the node arrays.
    """
    d2 = (patch_strike[:, None] - node_strike[None, :]) ** 2 + \
         (patch_dip[:, None] - node_dip[None, :]) ** 2
    return jnp.argmin(d2, axis=1).astype(jnp.int32)


def nearest_voronoi_node_numpy(node_strike, node_dip, patch_strike, patch_dip):
    """Host reference (mirrors ``beat/voronoi/voronoi.py:32``)."""
    d2 = (np.asarray(patch_strike)[:, None] - np.asarray(node_strike)[None, :]) ** 2 + \
         (np.asarray(patch_dip)[:, None] - np.asarray(node_dip)[None, :]) ** 2
    return np.argmin(d2, axis=1).astype(np.int32)
