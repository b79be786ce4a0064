"""
The GF-table gather (``GreensTable.gather_spectra``, the one path kept
for the GPU) against the numpy float64 bilinear reference
``gather_spectra_numpy``: grid edge cases, clamping, the fused channel
selection, vmap over chains and the gradient.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from beat_tpu.heart.gftable import build_homogeneous_table, gather_spectra_numpy

#: float32 blend of 4 rows against float64: a few ulps of the table's
#: largest value (the fractional index is float32 as well)
ATOL = 2e-6

GRIDS = {"1x5": (1, 5), "11x1": (11, 1), "2x2": (2, 2), "11x5": (11, 5)}


def make_table(nd, nz):
    d = np.linspace(20e3, 120e3, nd) if nd > 1 else np.array([60e3])
    z = np.linspace(2e3, 20e3, nz) if nz > 1 else np.array([8e3])
    return build_homogeneous_table(distances=d, depths=z, nt=64, dt=0.5)


def queries(table, kind, rng, n=7):
    d, z = np.asarray(table.distances), np.asarray(table.depths)
    if kind == "interior":
        dist = rng.uniform(d[0], d[-1], n) if d.size > 1 else np.full(n, d[0])
        depth = rng.uniform(z[0], z[-1]) if z.size > 1 else z[0]
    elif kind == "top_edge":
        # exactly on the last node: the cell clamps to the last cell
        # and the weight reaches 1.0, so the node's row comes back
        dist = np.full(n, d[-1])
        depth = z[-1]
    else:                                   # outside: clamped to the grid
        dist = np.concatenate([rng.uniform(0.0, d[0] - 1e3, n // 2),
                               rng.uniform(d[-1] + 1e3, 300e3, n - n // 2)])
        depth = z[-1] + 7e3
    return dist.astype(np.float32), np.float32(depth)


@pytest.mark.parametrize("kind", ["interior", "top_edge", "out_of_range"])
@pytest.mark.parametrize("with_comp", [True, False])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_gather_matches_reference(grid, with_comp, kind):
    table = make_table(*GRIDS[grid])
    rng = np.random.default_rng(0)
    dist, depth = queries(table, kind, rng)
    cidx = rng.integers(0, 3, dist.size) if with_comp else None
    got = np.asarray(table.gather_spectra(
        jnp.asarray(dist), jnp.float32(depth),
        None if cidx is None else jnp.asarray(cidx, dtype=jnp.int32)))
    ref = gather_spectra_numpy(table, dist, depth, cidx)
    assert got.shape == ref.shape
    scale = np.abs(np.asarray(table.spectra)).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=ATOL)
    if kind == "top_edge":
        sp = np.asarray(table.spectra)
        node = (sp[:, cidx, -1, -1] if with_comp
                else np.broadcast_to(sp[:, :, -1, -1][:, :, None],
                                     (6, 3, dist.size) + sp.shape[4:]))
        want = np.moveaxis(node, 2 if not with_comp else 1, 0)
        np.testing.assert_allclose(got / scale, want / scale, atol=ATOL)


def test_gather_vmapped_over_chains():
    """Per-chain depth and distances under vmap — the sampler's shape —
    equal the per-chain reference."""
    table = make_table(11, 5)
    rng = np.random.default_rng(1)
    dist = rng.uniform(15e3, 125e3, (6, 4)).astype(np.float32)
    depth = rng.uniform(1e3, 21e3, 6).astype(np.float32)
    cidx = rng.integers(0, 3, 4)
    got = np.asarray(jax.jit(jax.vmap(
        lambda d, z: table.gather_spectra(d, z, jnp.asarray(cidx))))(
        jnp.asarray(dist), jnp.asarray(depth)))
    ref = gather_spectra_numpy(table, dist, depth, cidx)
    np.testing.assert_array_equal(ref[2], gather_spectra_numpy(
        table, dist[2], depth[2], cidx))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=ATOL)


@pytest.mark.parametrize("wrt", ["distance", "depth"])
def test_gather_gradient_matches_finite_differences(wrt):
    """The bilinear weights carry the gradient (MALA/HMC): inside a cell
    d(out)/d(x) equals the central difference of the float64
    reference."""
    table = make_table(11, 5)
    dist = np.array([43.3e3, 87.9e3], np.float32)
    depth = np.float32(9.1e3)
    cidx = np.array([0, 2])
    w = np.random.default_rng(2).normal(size=(2, 6, table.spectra.shape[4], 2))

    def f(dd, zz):
        g = table.gather_spectra(dd, zz, jnp.asarray(cidx))
        return jnp.sum(g * w)

    argnum = 0 if wrt == "distance" else 1
    grad = np.asarray(jax.grad(f, argnums=argnum)(jnp.asarray(dist), depth))

    def ref(dd, zz):
        return float(np.sum(gather_spectra_numpy(table, dd, zz, cidx) * w))

    h = 1.0    # metres; the cells are 10 km and 4.5 km wide
    if wrt == "distance":
        fd = [(ref(dist + h * e, depth) - ref(dist - h * e, depth)) / (2 * h)
              for e in np.eye(2)]
    else:
        fd = (ref(dist, depth + h) - ref(dist, depth - h)) / (2 * h)
    # float32 gradient against float64 central differences
    np.testing.assert_allclose(grad, fd, rtol=1e-3,
                               atol=1e-3 * np.abs(fd).max())
