"""
Rectangular-dislocation surface displacements in an elastic halfspace
(Okada, BSSA 1985) — pure JAX.

Role in the framework: the hermetic analytic geodetic forward engine.
The reference computes static displacements through pyrocko's
psgrn/pscmp layered-earth Green's-function stores
(``beat/heart.py:4158`` ``geo_synthetics``); this module provides the
homogeneous-halfspace analytic equivalent so geometry-mode geodetic
inversions and FFI Green's-function *library* construction
(``beat/ffi/base.py:824`` ``geo_construct_gf_linear``) run entirely
on-device with no external Fortran stores.  Layered-earth GF tables can
be dropped in via :mod:`beat_tpu.heart.gftable` when available.

Everything is vectorised over observation points and differentiable;
``vmap`` over sources/chains composes freely.

Conventions
-----------
* Internal ``_okada_finite`` follows Okada's original frame: fault origin
  at depth ``d``, plane extending ``0 ≤ ξ ≤ L`` along strike (+x) and
  ``0 ≤ η ≤ W`` up-dip; ``y`` is horizontal, 90° counter-clockwise from
  the strike axis; dip ``δ`` measured down from horizontal towards +y.
* Public :func:`okada_surface_displacement` takes geographic parameters
  (east/north/depth of the **top-center** anchor, strike clockwise from
  north, dip, rake, slip, opening) and returns (N, 3) displacements in
  (east, north, up) — matching the dataset convention of the reference's
  ``geo_synthetics``.
"""

from __future__ import annotations

import jax.numpy as jnp

#: µ/(λ+µ) for a Poisson solid (ν = 0.25) — Okada's medium constant.
POISSON_DEFAULT = 0.25

_EPS = 1e-10


def _safe_div(num, den):
    """num/den with den guarded away from 0 (sign preserved)."""
    den_safe = jnp.where(jnp.abs(den) < _EPS, jnp.where(den >= 0, _EPS, -_EPS), den)
    return num / den_safe


def _okada_corner(xi, eta, q, dip, a):
    """
    Okada (1985) eqs. 25-30 "f(ξ, η)" corner terms for surface
    displacements of strike-slip, dip-slip and tensile elementary
    dislocations.  Returns a (3, 3) tuple-structure:
    (ux, uy, uz) for each of (strike, dip, tensile), each scalar/array.

    ``a`` = µ/(λ+µ).
    """
    sd = jnp.sin(dip)
    cd = jnp.cos(dip)

    R = jnp.sqrt(xi**2 + eta**2 + q**2)
    ytilde = eta * cd + q * sd
    dtilde = eta * sd - q * cd
    X = jnp.sqrt(xi**2 + q**2)

    R_eta = R + eta
    R_xi = R + xi
    R_d = R + dtilde

    # ln(R+η) diverges when R+η→0 (observation aligned behind the fault
    # edge); Okada's prescription: replace by -ln(R-η).
    ln_R_eta = jnp.where(jnp.abs(R_eta) < _EPS, -jnp.log(jnp.maximum(R - eta, _EPS)),
                         jnp.log(jnp.maximum(R_eta, _EPS)))
    ln_R_d = jnp.log(jnp.maximum(R_d, _EPS))

    inv_R_eta = jnp.where(jnp.abs(R_eta) < _EPS, 0.0, _safe_div(1.0, R_eta))
    inv_R_xi = jnp.where(jnp.abs(R_xi) < _EPS, 0.0, _safe_div(1.0, R_xi))

    # θ = atan(ξη / qR), zero where q == 0 (Okada's convention)
    theta = jnp.where(jnp.abs(q) < _EPS, 0.0,
                      jnp.arctan(_safe_div(xi * eta, q * R)))

    # --- I-terms (eqs. 28-29), with the cos δ → 0 limits (eq. 29') ---
    cd_zero = jnp.abs(cd) < 1e-6

    I5_gen = a * 2.0 / jnp.where(cd_zero, 1.0, cd) * jnp.arctan(
        _safe_div(eta * (X + q * cd) + X * (R + X) * sd, xi * (R + X) * cd)
    )
    I5_gen = jnp.where(jnp.abs(xi) < _EPS, 0.0, I5_gen)
    I5_lim = -a * _safe_div(xi * sd, R_d)
    I5 = jnp.where(cd_zero, I5_lim, I5_gen)

    I4_gen = a * (ln_R_d - sd * ln_R_eta) / jnp.where(cd_zero, 1.0, cd)
    I4_lim = -a * _safe_div(q, R_d)
    I4 = jnp.where(cd_zero, I4_lim, I4_gen)

    I3_gen = a * (_safe_div(ytilde, jnp.where(cd_zero, 1.0, cd) * R_d) - ln_R_eta) \
        + jnp.where(cd_zero, 0.0, sd / jnp.where(cd_zero, 1.0, cd)) * I4
    I3_lim = a / 2.0 * (_safe_div(eta, R_d) + _safe_div(ytilde * q, R_d**2) - ln_R_eta)
    I3 = jnp.where(cd_zero, I3_lim, I3_gen)

    I2 = a * (-ln_R_eta) - I3

    I1_gen = a * (-_safe_div(xi, jnp.where(cd_zero, 1.0, cd) * R_d)) \
        - jnp.where(cd_zero, 0.0, sd / jnp.where(cd_zero, 1.0, cd)) * I5
    I1_lim = -a / 2.0 * _safe_div(xi * q, R_d**2)
    I1 = jnp.where(cd_zero, I1_lim, I1_gen)

    # --- strike-slip (eq. 25) ---
    ux_ss = _safe_div(xi * q, R * R_eta) * jnp.where(jnp.abs(R_eta) < _EPS, 0.0, 1.0) \
        + theta + I1 * sd
    uy_ss = _safe_div(ytilde * q, R) * inv_R_eta + _safe_div(q * cd, 1.0) * inv_R_eta + I2 * sd
    uz_ss = _safe_div(dtilde * q, R) * inv_R_eta + q * sd * inv_R_eta + I4 * sd

    # --- dip-slip (eq. 26) ---
    ux_ds = _safe_div(q, R) - I3 * sd * cd
    uy_ds = _safe_div(ytilde * q, R) * inv_R_xi + cd * theta - I1 * sd * cd
    uz_ds = _safe_div(dtilde * q, R) * inv_R_xi + sd * theta - I5 * sd * cd

    # --- tensile (eq. 27) ---
    ux_t = _safe_div(q**2, R) * inv_R_eta - I3 * sd**2
    uy_t = -_safe_div(dtilde * q, R) * inv_R_xi - sd * (_safe_div(xi * q, R) * inv_R_eta - theta) \
        - I1 * sd**2
    uz_t = _safe_div(ytilde * q, R) * inv_R_xi + cd * (_safe_div(xi * q, R) * inv_R_eta - theta) \
        - I5 * sd**2

    return (ux_ss, uy_ss, uz_ss), (ux_ds, uy_ds, uz_ds), (ux_t, uy_t, uz_t)


def _okada_finite(x, y, d, dip, L, W, U1, U2, U3, a=0.5):
    """
    Surface displacement (ux, uy, uz) in Okada's fault frame for a finite
    rectangular source via the Chinnery notation
    ``f(x,p) - f(x,p-W) - f(x-L,p) + f(x-L,p-W)`` (Okada 1985 eq. 24).

    x, y: observation coordinates; d: depth of the fault *origin*
    (down-dip edge); dip in radians; U1/U2/U3 strike/dip/tensile
    dislocation; a = µ/(λ+µ).
    """
    sd = jnp.sin(dip)
    cd = jnp.cos(dip)
    p = y * cd + d * sd
    q = y * sd - d * cd

    out = []
    for comp in range(3):
        acc = [jnp.zeros_like(x + y)] * 3
        for xi0, eta0, sign in ((x, p, 1.0), (x, p - W, -1.0),
                                (x - L, p, -1.0), (x - L, p - W, 1.0)):
            corners = _okada_corner(xi0, eta0, q, dip, a)
            terms = corners[comp]
            acc = [acci + sign * t for acci, t in zip(acc, terms)]
        out.append(acc)

    # eqs. 25/26 carry -U/(2π); the tensile component (eq. 27) carries +U3/(2π).
    U = (-U1, -U2, U3)
    ux = sum(U[i] / (2 * jnp.pi) * out[i][0] for i in range(3))
    uy = sum(U[i] / (2 * jnp.pi) * out[i][1] for i in range(3))
    uz = sum(U[i] / (2 * jnp.pi) * out[i][2] for i in range(3))
    return ux, uy, uz


def mogi_surface_displacement(coords, east_shift=0.0, north_shift=0.0,
                              depth=3000.0, volume_change=1e6, nu=POISSON_DEFAULT):
    """
    Mogi (1958) point pressure source in a halfspace: surface
    displacements of a volume change ΔV at depth d,

        u_h = (1-ν)·ΔV/π · Δx / R³ ,   u_z = (1-ν)·ΔV/π · d / R³ .

    The geodetic forward for ExplosionSource geometry problems (the
    reference reaches volcano statics through psgrn/pscmp stores; this is
    the analytic halfspace equivalent).  Returns (N, 3) (E, N, Up) [m].
    """
    coords = jnp.asarray(coords)
    dx = coords[:, 0] - east_shift
    dy = coords[:, 1] - north_shift
    R = jnp.sqrt(dx**2 + dy**2 + depth**2)
    c = (1.0 - nu) * volume_change / jnp.pi
    inv_r3 = 1.0 / jnp.maximum(R, 1.0) ** 3
    return jnp.stack([c * dx * inv_r3, c * dy * inv_r3, c * depth * inv_r3],
                     axis=-1)


def mt_surface_displacement(coords, m6, east_shift=0.0, north_shift=0.0,
                            depth=5000.0, nu=POISSON_DEFAULT,
                            shear_modulus=33e9, patch_frac=0.08):
    """
    Halfspace surface displacements of an arbitrary moment-tensor point
    source, built from the rectangular kernel: M (symmetric) decomposes
    into three orthogonal tensile cracks along its eigenvectors —
    M = Σᵢ pᵢ (λ I + 2µ vᵢvᵢᵀ) with potencies
    pᵢ = (λᵢ − λ·tr(M)/(3λ+2µ)) / (2µ) — each realised as a small square
    Okada patch (side ``patch_frac·depth`` ≪ source depth, so the finite
    patches act as point sources at the surface).

    This closes the geometry-mode geodetic forward for MT/MTQT/CLVD/
    DoubleDC sources (the reference reaches it through psgrn/pscmp
    stores); valid for observation distances ≳ a few patch sizes.

    coords (N, 2) [m]; m6 = (mnn, mee, mdd, mne, mnd, med) [Nm].
    Returns (N, 3) displacements (E, N, Up).

    Implementation note: the displacement field is exactly
    LINEAR in M, so instead of eigen-decomposing the sampled tensor
    (data-dependent branches + float32 branch flips near degenerate
    eigenvalues — every DC is near-degenerate), M is expanded on a FIXED
    set of 9 crack normals (the 3 axes + the 6 axis bisectors) whose
    potencies are a static linear map of m6.  Branch-free, exactly
    linear, and the 9 small patches vmap into one fused kernel.
    """
    import jax

    mu = shear_modulus
    lam = 2.0 * mu * nu / (1.0 - 2.0 * nu)
    mnn, mee, mdd, mne, mnd, med = (jnp.asarray(m6)[..., i] for i in range(6))

    # diagonal bases: B_kk = c1 (λI + 2µ n_k n_kᵀ) + c2 Σ_{j≠k}(λI + 2µ n_j n_jᵀ)
    c1 = (lam + mu) / (mu * (3.0 * lam + 2.0 * mu))
    c2 = -lam / (2.0 * mu * (3.0 * lam + 2.0 * mu))
    # off-diagonal bases: ±1/(2µ) potency on the two 45° bisector normals
    q = 1.0 / (2.0 * mu)
    potencies = jnp.stack([
        c1 * mnn + c2 * (mee + mdd),      # normal N
        c1 * mee + c2 * (mnn + mdd),      # normal E
        c1 * mdd + c2 * (mnn + mee),      # normal D
        q * mne, -q * mne,                # normals (N±E)/√2
        q * mnd, -q * mnd,                # normals (N±D)/√2
        q * med, -q * med,                # normals (E±D)/√2
    ])
    # (strike φ, dip δ) of the crack plane for each fixed normal, from
    # ν = (−sinδ sinφ, sinδ cosφ, −cosδ) with ν_d ≤ 0
    strikes = jnp.array([-90.0, 0.0, 0.0, -45.0, -135.0,
                         90.0, -90.0, 180.0, 0.0])
    dips = jnp.array([90.0, 90.0, 0.0, 90.0, 90.0,
                      45.0, 45.0, 45.0, 45.0])

    size = patch_frac * depth
    area = size * size

    def one_crack(phi, delta, pot):
        return okada_surface_displacement(
            coords, east_shift=east_shift, north_shift=north_shift,
            depth=depth, strike=phi, dip=delta, rake=0.0,
            length=size, width=size, slip=0.0, opening=pot / area,
            nu=nu, anchor="center")

    return jnp.sum(jax.vmap(one_crack)(strikes, dips, potencies), axis=0)


def okada_surface_displacement(
    coords,
    east_shift=0.0,
    north_shift=0.0,
    depth=1.0,
    strike=0.0,
    dip=90.0,
    rake=0.0,
    length=1.0,
    width=1.0,
    slip=0.0,
    opening=0.0,
    nu=POISSON_DEFAULT,
    anchor="top",
):
    """
    Surface displacements of a rectangular dislocation.

    Parameters
    ----------
    coords : (N, 2) observation points (east, north) [m].
    east_shift, north_shift, depth : anchor position [m]; ``anchor`` is
        'top' (top-center, the beat ``RectangularSource`` convention,
        ``beat/sources.py:118-157``), 'center' or 'bottom'.
    strike [deg clockwise from north], dip [deg], rake [deg],
    length, width [m], slip [m], opening [m] (tensile).
    nu : Poisson ratio.

    Returns
    -------
    (N, 3) displacements (east, north, up) [m].
    """
    coords = jnp.asarray(coords)
    phi = jnp.deg2rad(strike)
    delta = jnp.deg2rad(dip)
    rake_r = jnp.deg2rad(rake)
    a = 1.0 - 2.0 * nu  # µ/(λ+µ) for λ=µ-scaled Poisson solid

    U1 = slip * jnp.cos(rake_r)
    U2 = slip * jnp.sin(rake_r)
    U3 = opening

    # anchor -> depth of the fault's down-dip edge (Okada origin) and the
    # horizontal position of the origin corner (ξ=0, η=0).
    sd = jnp.sin(delta)
    cd = jnp.cos(delta)
    if anchor == "top":
        d_origin = depth + width * sd
        # top-center anchor sits at η=W, mid-strike
        y_off = width * cd
    elif anchor == "center":
        d_origin = depth + 0.5 * width * sd
        y_off = 0.5 * width * cd
    elif anchor == "bottom":
        d_origin = depth
        y_off = 0.0
    else:
        raise ValueError(f"Unknown anchor '{anchor}'")

    # unit vectors: along-strike s, horizontal dip-direction t (=strike+90°).
    # Okada's frame dips toward -y (the fault shallows in +η whose horizontal
    # part is +y), so the geographic down-dip axis t maps to -y_okada;
    # x_okada = s keeps the frame right-handed with z up.
    s_e, s_n = jnp.sin(phi), jnp.cos(phi)
    t_e, t_n = jnp.cos(phi), -jnp.sin(phi)

    rel_e = coords[:, 0] - east_shift
    rel_n = coords[:, 1] - north_shift
    # fault-frame coordinates relative to the Okada origin (down-dip edge,
    # ξ = 0): the anchor sits at mid-strike (x = L/2) and y_off up-dip.
    x = rel_e * s_e + rel_n * s_n + 0.5 * length
    y = -(rel_e * t_e + rel_n * t_n) + y_off

    ux, uy, uz = _okada_finite(x, y, d_origin, delta, length, width, U1, U2, U3, a)

    ue = ux * s_e - uy * t_e
    un = ux * s_n - uy * t_n
    return jnp.stack([ue, un, uz], axis=-1)
