"""
Triangular-dislocation elastic kernels (full space and half-space).

The reference reaches these through the cutde CUDA library
(Nikkhoo & Walter halfspace TDEs, ``beat/bem/base.py:14-19``).  Here the
kernels are built from first principles in JAX:

* two hand-written point-force solutions only: the Kelvin full-space
  solution ``U_ki = [ (3-4ν) δ_ki + r̂_k r̂_i ] / (16 π µ (1-ν) r)`` and
  the Mindlin (1936) half-space solution (Kelvin + image + corrective
  terms; traction-free surface at z=0, z positive down) — the latter
  verified in tests to (a) reduce to Kelvin at depth, (b) reduce to
  Boussinesq-Cerruti at c→0, and (c) have an autodiff-computed
  traction that vanishes on z=0;
* a dislocation element is its moment-density surface distribution
  (representation theorem): ``u_k(x) = ∫_S m_pq ∂U_kp/∂ξ_q dS`` with
  ``m = λ (b·n) I + µ (b nᵀ + n bᵀ)``;
* ALL derivatives (source gradients for displacements, receiver
  gradients for strains/tractions) come from ``jax.jacfwd`` — no
  error-prone hand-derived kernels;
* surface integrals use fixed-depth triangle subdivision quadrature
  (4^L congruent subtriangles, centroid rule) — exact enough at BEM
  evaluation distances (≥ ~1 element size), verified against the Burgers
  discontinuity and the analytic penny-shaped-crack solution.

``medium='halfspace'`` (the default in
:class:`beat_tpu.bem.base.BEMEngine`, matching the reference's cutde HS
kernels) uses Mindlin interaction tractions; surface observation points
use the exact reciprocity kernel (Boussinesq-Cerruti at the buried
point), which tests cross-validate against the Mindlin field at z→0.
Self-interaction tractions are evaluated at a small normal offset from
the element centroid (standard collocation regularisation).
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger("beat_tpu.bem.tde")


import contextlib


def _assembly_scope():
    """float64 on the HOST CPU backend for the BEM quadrature.

    BEM assembly is a host-side precompute off the sampler's hot path,
    run in float64 (the nested-jacfwd second derivatives of
    :func:`element_stress` included).  The host CPU computes float64 at
    full rate, and the accelerator's memory stays free for the
    sampler's arrays."""
    stack = contextlib.ExitStack()
    stack.enter_context(jax.enable_x64(True))
    try:
        cpus = jax.devices("cpu")
        stack.enter_context(jax.default_device(cpus[0]))
    except RuntimeError:  # no CPU platform registered — use the default
        pass
    return stack


def kelvin_displacement(x, xi, mu=33e9, nu=0.25):
    """Kelvin solution U (3, 3): displacement component k at ``x`` per
    unit point force in direction i at ``xi`` (full space)."""
    r_vec = x - xi
    r = jnp.sqrt(jnp.sum(r_vec**2) + 1e-12)
    rhat = r_vec / r
    return ((3.0 - 4.0 * nu) * jnp.eye(3) + jnp.outer(rhat, rhat)) / \
        (16.0 * jnp.pi * mu * (1.0 - nu) * r)


def mindlin_displacement(x, xi, mu=33e9, nu=0.25):
    """
    Mindlin (1936) point-force solution in the half-space ``z >= 0``
    with a traction-free surface at ``z = 0`` (z positive DOWN, i.e.
    into the solid — the mesh convention of :mod:`beat_tpu.bem.sources`).

    Returns (3, 3): displacement component k at ``x`` per unit point
    force in direction i at ``xi`` (columns: +east, +north, +down).

    Limits (verified in tests/test_bem.py): c,z → ∞ recovers
    :func:`kelvin_displacement`; c → 0 recovers
    :func:`boussinesq_cerruti_displacement`; the surface traction
    σ(z=0)·ẑ vanishes (computed by autodiff).
    """
    dx = x[0] - xi[0]
    dy = x[1] - xi[1]
    z = x[2]
    c = xi[2]
    r2h = dx * dx + dy * dy
    R1 = jnp.sqrt(r2h + (z - c) ** 2 + 1e-12)
    R2 = jnp.sqrt(r2h + (z + c) ** 2 + 1e-12)
    zc = z + c
    zm = z - c
    S = R2 + zc
    A = 1.0 / (16.0 * jnp.pi * mu * (1.0 - nu))
    m34 = 3.0 - 4.0 * nu
    q = 4.0 * (1.0 - nu) * (1.0 - 2.0 * nu)

    def horizontal(a, b_):
        """Force along the horizontal unit axis whose coordinate is a
        (the other horizontal coordinate is b_): returns (u_a, u_b, u_z)."""
        u_a = A * (m34 / R1 + 1.0 / R2 + a * a / R1**3 + m34 * a * a / R2**3
                   + 2.0 * c * z / R2**3 * (1.0 - 3.0 * a * a / R2**2)
                   + q / S * (1.0 - a * a / (R2 * S)))
        u_b = A * a * b_ * (1.0 / R1**3 + m34 / R2**3 - 6.0 * c * z / R2**5
                            - q / (R2 * S**2))
        u_z = A * a * (zm / R1**3 + m34 * zm / R2**3 - 6.0 * c * z * zc / R2**5
                       + q / (R2 * S))
        return u_a, u_b, u_z

    # force along +x (east)
    uxx, uyx, uzx = horizontal(dx, dy)
    # force along +y (north): same solution with the horizontal axes swapped
    uyy, uxy, uzy = horizontal(dy, dx)
    # force along +z (down): Mindlin's vertical-load solution
    ur = A * (zm / R1**3 + m34 * zm / R2**3 - q / (R2 * S)
              + 6.0 * c * z * zc / R2**5)
    uxz = dx * ur
    uyz = dy * ur
    uzz = A * (m34 / R1 + (8.0 * (1.0 - nu) ** 2 - m34) / R2
               + zm**2 / R1**3 + (m34 * zc**2 - 2.0 * c * z) / R2**3
               + 6.0 * c * z * zc**2 / R2**5)

    # rows: displacement component at x; columns: force direction at xi
    return jnp.array([[uxx, uxy, uxz],
                      [uyx, uyy, uyz],
                      [uzx, uzy, uzz]])


def moment_density(b, n, mu=33e9, lam=33e9):
    """m_pq = λ(b·n)δ_pq + µ(b_p n_q + b_q n_p) per unit area."""
    return lam * jnp.dot(b, n) * jnp.eye(3) + mu * (jnp.outer(b, n) + jnp.outer(n, b))


def _greens_fn(medium: str):
    if medium == "fullspace":
        return kelvin_displacement
    elif medium == "halfspace":
        return mindlin_displacement
    raise ValueError(f"Unknown medium {medium!r} (fullspace|halfspace)")


def point_dislocation_displacement(x, xi, m_pq, mu=33e9, nu=0.25,
                                   medium="fullspace"):
    """u_k(x) of a point moment m_pq at ξ: m_pq ∂U_kp/∂ξ_q (autodiff)."""
    green = _greens_fn(medium)
    dU = jax.jacfwd(lambda s: green(x, s, mu, nu))(xi)  # (k,p,q)
    return jnp.einsum("pq,kpq->k", m_pq, dU)


def _subdivide(tri, level: int):
    """Centroids + equal areas of 4^level congruent subtriangles."""
    tris = [np.asarray(tri, dtype=np.float64)]
    for _ in range(level):
        new = []
        for t in tris:
            m01 = (t[0] + t[1]) / 2
            m12 = (t[1] + t[2]) / 2
            m20 = (t[2] + t[0]) / 2
            new += [np.array([t[0], m01, m20]), np.array([m01, t[1], m12]),
                    np.array([m20, m12, t[2]]), np.array([m01, m12, m20])]
        tris = new
    cents = np.stack([t.mean(axis=0) for t in tris])
    t0 = np.asarray(tri)
    area = 0.5 * np.linalg.norm(np.cross(t0[1] - t0[0], t0[2] - t0[0]))
    return cents, area / len(tris)


def element_displacement(obs, tri, b, mu=33e9, nu=0.25, lam=None, level: int = 2,
                         medium: str = "fullspace"):
    """
    Displacement at points ``obs`` (N, 3) from a uniform Burgers vector
    ``b`` on triangle ``tri`` (3, 3), quadrature level ``level``
    (4^level points); ``medium`` picks the Kelvin (fullspace) or Mindlin
    (halfspace, free surface at z=0) point-force kernel.

    Runs in float64 (``jax.enable_x64`` scope): the quadrature sums cancel
    to ~1e-7 of their largest terms — float32 noise would dominate the
    physical field.  BEM assembly is a host-side precompute, so this
    costs nothing on device.
    """
    lam = 2.0 * mu * nu / (1.0 - 2.0 * nu) if lam is None else lam
    tri_np = np.asarray(tri, dtype=np.float64)
    n_vec = np.cross(tri_np[1] - tri_np[0], tri_np[2] - tri_np[0])
    n_vec = n_vec / np.linalg.norm(n_vec)
    cents, dA = _subdivide(tri_np, level)

    with _assembly_scope():
        m = moment_density(jnp.asarray(b, dtype=jnp.float64),
                           jnp.asarray(n_vec), mu, lam) * dA

        def disp_at(x):
            contrib = jax.vmap(lambda c: point_dislocation_displacement(
                x, c, m, mu, nu, medium))(jnp.asarray(cents))
            return jnp.sum(contrib, axis=0)

        return np.asarray(jax.vmap(disp_at)(
            jnp.asarray(obs, dtype=jnp.float64)))


def element_stress(obs, tri, b, mu=33e9, nu=0.25, lam=None, level: int = 2,
                   medium: str = "fullspace"):
    """Stress tensors (N, 3, 3) at ``obs`` from the element (autodiff of
    the displacement field over the receiver coordinate; float64, see
    :func:`element_displacement`)."""
    lam = 2.0 * mu * nu / (1.0 - 2.0 * nu) if lam is None else lam
    tri_np = np.asarray(tri, dtype=np.float64)
    n_vec = np.cross(tri_np[1] - tri_np[0], tri_np[2] - tri_np[0])
    n_vec = n_vec / np.linalg.norm(n_vec)
    cents, dA = _subdivide(tri_np, level)

    with _assembly_scope():
        m = moment_density(jnp.asarray(b, dtype=jnp.float64),
                           jnp.asarray(n_vec), mu, lam) * dA

        def disp_at(x):
            contrib = jax.vmap(lambda c: point_dislocation_displacement(
                x, c, m, mu, nu, medium))(jnp.asarray(cents))
            return jnp.sum(contrib, axis=0)

        def stress_at(x):
            grad = jax.jacfwd(disp_at)(x)          # du_k/dx_l
            eps = 0.5 * (grad + grad.T)
            return lam * jnp.trace(eps) * jnp.eye(3) + 2.0 * mu * eps

        return np.asarray(jax.vmap(stress_at)(
            jnp.asarray(obs, dtype=jnp.float64)))


# ---------------------------------------------------------------------------
# Halfspace surface displacements via reciprocity
# ---------------------------------------------------------------------------


def boussinesq_cerruti_displacement(xi, x0, mu=33e9, nu=0.25):
    """
    Displacement (3, 3) at interior point ``xi`` (z = depth, positive
    down) per unit point force applied at the FREE SURFACE point ``x0``
    (z=0): columns = force direction (x, y, z-down); Boussinesq (normal
    load) + Cerruti (tangential load) halfspace solutions.
    """
    d = xi - x0                      # (dx, dy, z)
    x, y, z = d[0], d[1], d[2]
    R = jnp.sqrt(x * x + y * y + z * z + 1e-12)
    Rz = R + z
    k = 1.0 / (4.0 * jnp.pi * mu)
    om = 1.0 - 2.0 * nu

    # Cerruti: unit tangential force along x
    ux_x = k * (1.0 / R + x * x / R**3 + om * (1.0 / Rz - x * x / (R * Rz**2)))
    uy_x = k * (x * y / R**3 - om * x * y / (R * Rz**2))
    uz_x = k * (x * z / R**3 + om * x / (R * Rz))
    # unit tangential force along y (swap roles of x and y)
    ux_y = k * (x * y / R**3 - om * x * y / (R * Rz**2))
    uy_y = k * (1.0 / R + y * y / R**3 + om * (1.0 / Rz - y * y / (R * Rz**2)))
    uz_y = k * (y * z / R**3 + om * y / (R * Rz))
    # Boussinesq: unit normal force (z down)
    ux_z = k * (x * z / R**3 - om * x / (R * Rz))
    uy_z = k * (y * z / R**3 - om * y / (R * Rz))
    uz_z = k * (z * z / R**3 + 2.0 * (1.0 - nu) / R)

    # rows: displacement component at xi; columns: force direction at x0
    return jnp.array([[ux_x, ux_y, ux_z],
                      [uy_x, uy_y, uy_z],
                      [uz_x, uz_y, uz_z]])


def element_surface_displacement_halfspace(obs_xy, tri, b, mu=33e9, nu=0.25,
                                           lam=None, level: int = 3):
    """
    EXACT halfspace surface displacements of a buried triangular
    dislocation, by reciprocity: the Green's function from a buried point
    to the free surface equals the Boussinesq-Cerruti field of a surface
    point force evaluated at the buried point (G_kp(x0, ξ) = G_pk(ξ, x0)),
    so only the (simple) surface-force solutions are needed — source
    derivatives again via autodiff.

    obs_xy : (N, 2) surface points (east, north); tri in (E, N, depth>0).
    Returns (N, 3) displacements (x=east, y=north, z-down) — callers flip
    the z sign for up-positive conventions.
    """
    lam = 2.0 * mu * nu / (1.0 - 2.0 * nu) if lam is None else lam
    tri_np = np.asarray(tri, dtype=np.float64)
    n_vec = np.cross(tri_np[1] - tri_np[0], tri_np[2] - tri_np[0])
    n_vec = n_vec / np.linalg.norm(n_vec)
    cents, dA = _subdivide(tri_np, level)

    with _assembly_scope():
        m = moment_density(jnp.asarray(b, dtype=jnp.float64),
                           jnp.asarray(n_vec), mu, lam) * dA

        def disp_at(x0_xy):
            x0 = jnp.concatenate([x0_xy, jnp.zeros(1)])

            def one(c):
                # dG_pk/dξ_q of the surface-force Green's function
                dG = jax.jacfwd(lambda s: boussinesq_cerruti_displacement(
                    s, x0, mu, nu))(c)       # (p, k, q)
                return jnp.einsum("pq,pkq->k", m, dG)

            return jnp.sum(jax.vmap(one)(jnp.asarray(cents)), axis=0)

        return np.asarray(jax.vmap(disp_at)(
            jnp.asarray(obs_xy, dtype=jnp.float64)))


# ---------------------------------------------------------------------------
# BEM assembly (consumed by beat_tpu.bem.base.BEMEngine)
# ---------------------------------------------------------------------------


def _slip_vector(mesh, idx, component):
    if component == "strike":
        return mesh.unit_strike_vectors[idx]
    elif component == "dip":
        return mesh.unit_dip_vectors[idx]
    elif component == "normal":
        return mesh.normals[idx]
    raise ValueError(f"Unknown slip component {component}")


def interaction_matrix(meshes, boundary_conditions, nu=0.25, mu=33e9,
                       level: int = 2, near_level: int = 6,
                       self_offset_frac: float = 0.5,
                       medium: str = "fullspace"):
    """
    Traction interaction matrix: rows = receiver-element
    BC tractions (projected on the BC slip direction), columns = unit
    slips of source elements per BC (reference ``get_interaction_matrix``
    ``bem/base.py:230`` + traction projections :278).

    Collocation points sit ``self_offset_frac · sqrt(area)`` along the
    receiver normal (offset collocation regularises the self term);
    entries whose collocation point lies within two element sizes of the
    source are recomputed at ``near_level`` subdivision so quadrature
    point sources never dominate the near field.
    """
    col_meta = []
    for bc in boundary_conditions:
        for src_i in bc.source_idxs:
            mesh = meshes[src_i]
            for e in range(mesh.ntriangles):
                col_meta.append((bc.slip_component, src_i, e))
    # receiver collocation points per BC row block
    rec_points, rec_normals, rec_dirs = [], [], []
    for bc in boundary_conditions:
        for rec_i in bc.receiver_idxs:
            mesh = meshes[rec_i]
            off = (self_offset_frac * np.sqrt(mesh.areas))[:, None] * mesh.normals
            rec_points.append(mesh.centroids + off)
            rec_normals.append(mesh.normals)
            rec_dirs.append(np.stack([
                _slip_vector(mesh, e, bc.slip_component)
                for e in range(mesh.ntriangles)]))
    rec_points = np.concatenate(rec_points)
    rec_normals = np.concatenate(rec_normals)
    rec_dirs = np.concatenate(rec_dirs)

    G = np.zeros((rec_points.shape[0], len(col_meta)))
    for j, (component, src_i, e) in enumerate(col_meta):
        mesh = meshes[src_i]
        tri = mesh.triangles[e]
        b = _slip_vector(mesh, e, component)
        sigma = np.asarray(element_stress(rec_points, tri, b, mu=mu, nu=nu,
                                          level=level, medium=medium))
        traction = np.einsum("nij,nj->ni", sigma, rec_normals)
        G[:, j] = np.einsum("ni,ni->n", traction, rec_dirs)

        # near-field rows: recompute at fine subdivision
        size = np.sqrt(mesh.areas[e])
        dist = np.linalg.norm(rec_points - tri.mean(axis=0), axis=1)
        near = np.where(dist < 2.0 * size)[0]
        if near.size:
            sigma_n = np.asarray(element_stress(
                rec_points[near], tri, b, mu=mu, nu=nu,
                level=near_level, medium=medium))
            traction_n = np.einsum("nij,nj->ni", sigma_n, rec_normals[near])
            G[near, j] = np.einsum("ni,ni->n", traction_n, rec_dirs[near])
    logger.info("Assembled BEM interaction matrix %s", G.shape)
    return G


def displacement_matrix(meshes, coords, nu=0.25, mu=33e9, level: int = 3,
                        boundary_conditions=None, medium: str = "halfspace"):
    """
    Displacements (3·nobs, ncolumns) at observation points per unit
    element slip.  2-D coords = free-surface observations → the EXACT
    halfspace reciprocity kernel (validated to <0.1% against the Okada
    rectangular solution, and cross-validated against the Mindlin field
    at z→0); 3-D coords → the ``medium`` volume kernel.  Returned
    components are (east, north, up).  Column order matches
    :func:`interaction_matrix`.
    """
    coords = np.asarray(coords)
    surface = coords.shape[1] == 2

    cols = []
    for bc in (boundary_conditions or []):
        for src_i in bc.source_idxs:
            mesh = meshes[src_i]
            for e in range(mesh.ntriangles):
                b = _slip_vector(mesh, e, bc.slip_component)
                if surface:
                    disp = element_surface_displacement_halfspace(
                        coords, mesh.triangles[e], b, mu=mu, nu=nu,
                        level=level)
                    disp = np.stack([disp[:, 0], disp[:, 1], -disp[:, 2]],
                                    axis=-1)  # z-down -> up
                else:
                    disp = element_displacement(
                        coords, mesh.triangles[e], b, mu=mu, nu=nu,
                        level=level, medium=medium)
                    disp = np.asarray(disp)
                    # volume kernels are in the z-down frame too: flip to
                    # the documented (east, north, up) convention, same as
                    # the surface branch
                    disp = np.stack([disp[:, 0], disp[:, 1], -disp[:, 2]],
                                    axis=-1)
                cols.append(np.asarray(disp).reshape(-1))
    return np.stack(cols, axis=1)
