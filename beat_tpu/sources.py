"""
Source parameterizations.

Re-design of ``beat/sources.py`` without pyrocko: sources are light
dataclasses whose geometry/moment-tensor math is JAX-traceable, so a
sampler point maps to forward-model inputs entirely on device.

Catalog parity (reference ``source_catalog`` ``beat/sources.py:694-721``):
RectangularSource, MTSource, MTQTSource (Tape & Tape 2015 lune), DCSource,
ExplosionSource, plus the STF catalog (Boxcar/Triangular/HalfSinusoid,
``beat/sources.py:723-729``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

SQRT2 = math.sqrt(2.0)
SQRT3 = math.sqrt(3.0)
SQRT6 = math.sqrt(6.0)
PI4 = math.pi / 4.0

# pyrocko convention used throughout the reference:
# M0 [Nm] = 10^(1.5·(Mw + 10.7)) · 1e-7
MOMENT_EXP_OFFSET = 1.5 * 10.7 - 7.0  # = 9.05


def magnitude_to_moment(magnitude):
    return 10.0 ** (1.5 * magnitude + MOMENT_EXP_OFFSET)


def moment_to_magnitude(moment):
    return (jnp.log10(moment) - MOMENT_EXP_OFFSET) / 1.5


# ---------------------------------------------------------------------------
# Rotation helpers (NWU frame, as in Tape & Tape 2015)
# ---------------------------------------------------------------------------


def rot_x(angle):
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def rot_y(angle):
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def rot_z(angle):
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


# ---------------------------------------------------------------------------
# Moment-tensor conversions
# ---------------------------------------------------------------------------


@jax.jit
def sdr_to_m6(strike, dip, rake, moment=1.0):
    """
    Double couple (strike, dip, rake [deg]) -> MT components in NED basis
    (Aki & Richards box 4.4).  Returns (mnn, mee, mdd, mne, mnd, med)·M0.

    Jitted: eager callers (data synthesis, GCMT seeding, plots) would
    otherwise pay ~20 separate op dispatches.
    """
    phi = jnp.deg2rad(strike)
    delta = jnp.deg2rad(dip)
    lam = jnp.deg2rad(rake)
    sd, cd = jnp.sin(delta), jnp.cos(delta)
    s2d, c2d = jnp.sin(2 * delta), jnp.cos(2 * delta)
    sl, cl = jnp.sin(lam), jnp.cos(lam)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    s2p, c2p = jnp.sin(2 * phi), jnp.cos(2 * phi)

    mnn = -(sd * cl * s2p + s2d * sl * sp**2)
    mee = sd * cl * s2p - s2d * sl * cp**2
    mdd = s2d * sl
    mne = sd * cl * c2p + 0.5 * s2d * sl * s2p
    mnd = -(cd * cl * cp + c2d * sl * sp)
    med = -(cd * cl * sp - c2d * sl * cp)
    return moment * jnp.stack([mnn, mee, mdd, mne, mnd, med])


def tensile_m6(strike, dip, potency, lam=33e9, mu=33e9):
    """
    Moment tensor of a tensile crack opening normal to a plane with the
    given strike/dip [deg]: M = potency·(λ·I + 2µ·n nᵀ), NED basis.
    ``potency`` = area × opening [m³].
    """
    phi = jnp.deg2rad(strike)
    delta = jnp.deg2rad(dip)
    # fault normal (hanging-wall side, pointing up) in NED
    # (Aki & Richards): n = (-sinδ·sinφ, sinδ·cosφ, -cosδ)
    n_vec = jnp.stack([-jnp.sin(delta) * jnp.sin(phi),
                       jnp.sin(delta) * jnp.cos(phi),
                       -jnp.cos(delta)])
    nn = jnp.outer(n_vec, n_vec)
    M = potency * (lam * jnp.eye(3) + 2.0 * mu * nn)
    return matrix_to_m6(M)


def m6_to_matrix(m6):
    """(mnn, mee, mdd, mne, mnd, med) -> symmetric 3x3 in NED."""
    mnn, mee, mdd, mne, mnd, med = (m6[..., i] for i in range(6))
    row0 = jnp.stack([mnn, mne, mnd], axis=-1)
    row1 = jnp.stack([mne, mee, med], axis=-1)
    row2 = jnp.stack([mnd, med, mdd], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def matrix_to_m6(m):
    return jnp.stack([m[..., 0, 0], m[..., 1, 1], m[..., 2, 2],
                      m[..., 0, 1], m[..., 0, 2], m[..., 1, 2]], axis=-1)


# --- Tape & Tape 2015 lune parameterization (reference sources.py:403-599) --

_N_BETA = 1000
_BETA_TABLE = np.linspace(0.0, np.pi, _N_BETA)
_U_TABLE = (0.75 * _BETA_TABLE
            - 0.5 * np.sin(2.0 * _BETA_TABLE)
            + 0.0625 * np.sin(4.0 * _BETA_TABLE))

_LAMBDA_FACTOR = np.array(
    [[SQRT3, -1.0, SQRT2], [0.0, 2.0, SQRT2], [-SQRT3, -1.0, SQRT2]])


def v_to_gamma(v):
    """Lune longitude γ from v: v = (1/3)·sin(3γ)."""
    return jnp.arcsin(3.0 * v) / 3.0


def w_to_beta(w):
    """
    Lune colatitude β from w = (3π/8) − u, where
    u(β) = ¾β − ½sin2β + (1/16)sin4β, inverted by table interpolation
    (reference ``U_MAPPING``/``BETA_MAPPING`` ``beat/sources.py:31-37``).
    """
    u = 3.0 / 8.0 * jnp.pi - w
    return jnp.interp(u, jnp.asarray(_U_TABLE), jnp.asarray(_BETA_TABLE))


def mtqt_to_m6(w, v, kappa, sigma, h, magnitude):
    """
    (w, v, κ, σ, h, Mw) -> m6 in NED.  Orientation math in NWU then
    rotated to NED by Rx(π), as the reference does
    (``MTQTSource.m9`` ``beat/sources.py:528-534``).
    """
    rho = magnitude_to_moment(magnitude) * SQRT2
    beta = w_to_beta(w)
    gamma = v_to_gamma(v)
    theta = jnp.arccos(h)

    sb, cb = jnp.sin(beta), jnp.cos(beta)
    sg, cg = jnp.sin(gamma), jnp.cos(gamma)
    vec = jnp.stack([sb * cg, sb * sg, cb])
    lam = (1.0 / SQRT6) * (jnp.asarray(_LAMBDA_FACTOR) @ vec) * rho
    lam_matrix = jnp.diag(lam)

    rot_V = rot_z(-kappa) @ rot_x(theta) @ rot_z(sigma)
    rot_U = rot_V @ rot_y(-PI4)
    m_nwu = rot_U @ lam_matrix @ jnp.linalg.inv(rot_U)
    rx = rot_x(jnp.pi)
    m_ned = rx @ m_nwu @ rx.T
    return matrix_to_m6(m_ned)


# ---------------------------------------------------------------------------
# Source classes
# ---------------------------------------------------------------------------


@dataclass
class BaseSource:
    """Common location/time parameters of all sources."""

    east_shift: float = 0.0   # [m]
    north_shift: float = 0.0  # [m]
    depth: float = 1000.0     # [m]
    time: float = 0.0         # [s] relative to event reference
    duration: float = 1.0     # [s] source-time-function duration

    #: names the sampler may vary for this source type
    parameter_names = ("east_shift", "north_shift", "depth", "time")

    def to_dict(self):
        from dataclasses import asdict

        d = asdict(self)
        d["type"] = type(self).__name__
        return d


@dataclass
class RectangularSource(BaseSource):
    """
    Rectangular fault plane (reference ``beat.sources.RectangularSource``
    ``beat/sources.py:46-400``).  Anchor convention 'top' (top-center),
    with conversions as in the reference ``anchor`` handling (:118-157).
    """

    strike: float = 0.0   # [deg]
    dip: float = 90.0     # [deg]
    rake: float = 0.0     # [deg]
    length: float = 1000.0  # [m]
    width: float = 1000.0   # [m]
    slip: float = 1.0       # [m]
    opening_fraction: float = 0.0  # tensile fraction of slip
    anchor: str = "top"
    #: kinematic attributes (FFI mode)
    velocity: float = 3500.0      # rupture velocity [m/s]
    duration: float = 0.0         # STF duration [s]
    nucleation_x: float = 0.0     # [-1, 1] along strike
    nucleation_y: float = 0.0     # [-1, 1] down dip

    parameter_names = ("east_shift", "north_shift", "depth", "strike", "dip",
                       "rake", "length", "width", "slip", "opening_fraction",
                       "time", "velocity", "duration",
                       "nucleation_x", "nucleation_y")

    @property
    def dipvector(self) -> np.ndarray:
        """Unit vector down-dip (ENU, z negative down)
        (reference ``sources.py:56-70``)."""
        st, di = np.deg2rad(self.strike), np.deg2rad(self.dip)
        return np.array([np.cos(di) * np.cos(st),
                         -np.cos(di) * np.sin(st),
                         -np.sin(di)])

    @property
    def strikevector(self) -> np.ndarray:
        st = np.deg2rad(self.strike)
        return np.array([np.sin(st), np.cos(st), 0.0])

    def surface_displacement(self, coords, nu=0.25):
        """Static surface displacement (N, 3 = E,N,U) via Okada."""
        from beat_tpu.heart.okada import okada_surface_displacement

        slip_shear = self.slip * (1.0 - abs(self.opening_fraction))
        opening = self.slip * self.opening_fraction
        return okada_surface_displacement(
            coords,
            east_shift=self.east_shift, north_shift=self.north_shift,
            depth=self.depth, strike=self.strike, dip=self.dip,
            rake=self.rake, length=self.length, width=self.width,
            slip=slip_shear, opening=opening, nu=nu, anchor=self.anchor)

    def patches(self, n_length: int, n_width: int) -> list["RectangularSource"]:
        """
        Uniform discretization into n_length × n_width sub-faults
        (reference ``RectangularSource.patches``), each anchored 'top'.
        """
        pl = self.length / n_length
        pw = self.width / n_width
        st = np.deg2rad(self.strike)
        di = np.deg2rad(self.dip)
        s_vec = np.array([np.sin(st), np.cos(st)])        # E,N along strike
        d_vec_h = np.array([np.cos(st), -np.sin(st)])     # E,N horizontal dip dir
        out = []
        for iw in range(n_width):
            for il in range(n_length):
                # top-center anchor of this patch
                along = (il + 0.5) * pl - self.length / 2.0
                downdip = iw * pw
                e = self.east_shift + along * s_vec[0] + downdip * np.cos(di) * d_vec_h[0]
                n = self.north_shift + along * s_vec[1] + downdip * np.cos(di) * d_vec_h[1]
                z = self.depth + downdip * np.sin(di)
                out.append(RectangularSource(
                    east_shift=e, north_shift=n, depth=z, time=self.time,
                    strike=self.strike, dip=self.dip, rake=self.rake,
                    length=pl, width=pw, slip=self.slip,
                    opening_fraction=self.opening_fraction, anchor="top",
                    velocity=self.velocity))
        return out

    @property
    def bottom_depth(self):
        return self.depth + self.width * np.sin(np.deg2rad(self.dip))

    def center(self):
        """(E, N, Z) of the plane center [m]."""
        st, di = np.deg2rad(self.strike), np.deg2rad(self.dip)
        d_vec_h = np.array([np.cos(st), -np.sin(st)])
        half_w = 0.5 * self.width
        return np.array([
            self.east_shift + half_w * np.cos(di) * d_vec_h[0],
            self.north_shift + half_w * np.cos(di) * d_vec_h[1],
            self.depth + half_w * np.sin(di)])


@dataclass
class MTSource(BaseSource):
    """Full moment tensor with unit-normalised components + magnitude
    (reference ``MTSourceWithMagnitude`` ``beat/sources.py:599``)."""

    mnn: float = 1.0
    mee: float = 1.0
    mdd: float = 1.0
    mne: float = 0.0
    mnd: float = 0.0
    med: float = 0.0
    magnitude: float = 6.0

    parameter_names = ("east_shift", "north_shift", "depth", "time",
                       "mnn", "mee", "mdd", "mne", "mnd", "med", "magnitude")

    def m6(self):
        """Scaled MT: Frobenius-unit components × scalar moment
        (reference ``scaled_m6`` ``beat/sources.py:630-637``)."""
        comps = jnp.stack([self.mnn, self.mee, self.mdd,
                           self.mne, self.mnd, self.med])
        norm = jnp.sqrt(jnp.sum(comps[:3] ** 2) + 2.0 * jnp.sum(comps[3:] ** 2)) / SQRT2
        return comps / jnp.maximum(norm, 1e-20) * magnitude_to_moment(self.magnitude)


@dataclass
class MTQTSource(BaseSource):
    """Tape & Tape 2015 lune-parameterised MT (reference ``MTQTSource``)."""

    w: float = 0.0
    v: float = 0.0
    kappa: float = 0.0
    sigma: float = 0.0
    h: float = 0.5
    magnitude: float = 6.0

    parameter_names = ("east_shift", "north_shift", "depth", "time",
                       "w", "v", "kappa", "sigma", "h", "magnitude")

    def m6(self):
        return mtqt_to_m6(self.w, self.v, self.kappa, self.sigma, self.h,
                          self.magnitude)


@dataclass
class DCSource(BaseSource):
    """Double couple (strike/dip/rake/magnitude)."""

    strike: float = 0.0
    dip: float = 90.0
    rake: float = 0.0
    magnitude: float = 6.0

    parameter_names = ("east_shift", "north_shift", "depth", "time",
                       "strike", "dip", "rake", "magnitude")

    def m6(self):
        return sdr_to_m6(self.strike, self.dip, self.rake,
                         magnitude_to_moment(self.magnitude))


@dataclass
class ExplosionSource(BaseSource):
    """Isotropic source (volume change / magnitude)."""

    volume_change: float = 1e6  # [m^3]
    magnitude: float | None = None

    parameter_names = ("east_shift", "north_shift", "depth", "time",
                       "volume_change")

    def m6(self, shear_modulus=33e9):
        m0 = (magnitude_to_moment(self.magnitude) if self.magnitude is not None
              else shear_modulus * self.volume_change)
        return jnp.stack([m0, m0, m0, 0.0 * m0, 0.0 * m0, 0.0 * m0])


@dataclass
class CLVDSource(BaseSource):
    """Compensated linear vector dipole (reference catalog includes
    pyrocko's CLVDSource): symmetry axis from azimuth/dip."""

    azimuth: float = 0.0   # [deg] of the symmetry axis
    dip: float = 90.0      # [deg]
    magnitude: float = 6.0

    parameter_names = ("east_shift", "north_shift", "depth", "time",
                       "azimuth", "dip", "magnitude")

    def m6(self):
        az = jnp.deg2rad(self.azimuth)
        di = jnp.deg2rad(self.dip)
        # unit symmetry axis in NED
        a = jnp.stack([jnp.cos(az) * jnp.cos(di), jnp.sin(az) * jnp.cos(di),
                       jnp.sin(di)])
        m = jnp.outer(a, a) - jnp.eye(3) / 3.0
        m = m / jnp.sqrt(jnp.sum(m * m) / 2.0) * magnitude_to_moment(self.magnitude)
        return matrix_to_m6(m)


@dataclass
class DoubleDCSource(BaseSource):
    """Two double couples separated in space/time (reference catalog's
    pyrocko DoubleDCSource): mixing factor splits the moment."""

    strike1: float = 0.0
    dip1: float = 90.0
    rake1: float = 0.0
    strike2: float = 0.0
    dip2: float = 90.0
    rake2: float = 0.0
    mix: float = 0.5
    delta_time: float = 0.0
    delta_depth: float = 0.0
    distance: float = 0.0
    azimuth: float = 0.0
    magnitude: float = 6.0

    parameter_names = ("east_shift", "north_shift", "depth", "time",
                       "strike1", "dip1", "rake1", "strike2", "dip2", "rake2",
                       "mix", "delta_time", "delta_depth", "distance",
                       "azimuth", "magnitude")

    def m6_pair(self):
        m0 = magnitude_to_moment(self.magnitude)
        m1 = sdr_to_m6(self.strike1, self.dip1, self.rake1, (1.0 - self.mix) * m0)
        m2 = sdr_to_m6(self.strike2, self.dip2, self.rake2, self.mix * m0)
        return m1, m2

    def m6(self):
        m1, m2 = self.m6_pair()
        return m1 + m2  # co-located approximation (delta offsets small)


@dataclass
class RingfaultSource(BaseSource):
    """
    Ring fault (caldera collapse): ``npointsources`` double couples on a
    circle of ``diameter``, each tangent to the ring with vertical slip
    whose direction is set by ``sign`` (+1 = inner block down).  The
    ring plane can be tilted by (``strike``, ``dip``): rotation about
    the horizontal axis at azimuth ``strike``.  Reference catalog entry
    ``RingfaultSource`` (``beat/sources.py:694-721``, pyrocko
    ``gf.RingfaultSource`` semantics).
    """

    strike: float = 0.0       # [deg] tilt-axis azimuth of the ring plane
    dip: float = 0.0          # [deg] ring-plane tilt (0 = horizontal ring)
    diameter: float = 1000.0  # [m]
    sign: float = 1.0         # +1 collapse (inner side down), -1 uplift
    magnitude: float = 6.0
    npointsources: int = 8    # static discretization (not sampled)

    parameter_names = ("east_shift", "north_shift", "depth", "time",
                       "strike", "dip", "diameter", "sign", "magnitude")

    def sub_sources(self, get=None):
        """Traced decomposition into point double couples.

        get : name -> traced value (defaults to template attributes).
        Returns ``(m6s (n, 6) NED, de (n,), dn (n,), dz (n,))`` —
        offsets relative to (east_shift, north_shift, depth).
        """
        if get is None:
            def get(name):
                return jnp.asarray(getattr(self, name))

        n = int(self.npointsources)
        m0_each = magnitude_to_moment(get("magnitude")) / n
        r = get("diameter") / 2.0
        phis = jnp.arange(n) * (2.0 * jnp.pi / n)

        # ring-plane tilt: Rodrigues rotation about the horizontal axis
        # at azimuth `strike` (NED), by `dip`
        s = jnp.deg2rad(get("strike"))
        di = jnp.deg2rad(get("dip"))
        ax, ay = jnp.cos(s), jnp.sin(s)          # horizontal axis, NED
        zero = jnp.zeros(())
        K = jnp.stack([jnp.stack([zero, zero, ay]),
                       jnp.stack([zero, zero, -ax]),
                       jnp.stack([-ay, ax, zero])])
        R = (jnp.eye(3) + jnp.sin(di) * K
             + (1.0 - jnp.cos(di)) * (K @ K))

        def one(phi):
            p = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), jnp.zeros(())])
            p = R @ p                                  # NED offsets
            # tangent vertical fault: strike along the tangent, slip
            # vertical; sign=+1 -> inner block down (rake -90 on a
            # plane whose hanging wall faces the ring centre)
            strike_i = jnp.rad2deg(phi) + 90.0
            m = m6_to_matrix(sdr_to_m6(strike_i, 90.0, -90.0 * get("sign"),
                                       m0_each))
            m = R @ m @ R.T
            return matrix_to_m6(m), p[1], p[0], p[2]   # de, dn, dz

        m6s, de, dn, dz = jax.vmap(one)(phis)
        return m6s, de, dn, dz

    def m6(self):
        """Net moment tensor (sub-tensors largely cancel for a full ring —
        the composite dispatches the sub-sources individually)."""
        m6s, *_ = self.sub_sources()
        return jnp.sum(m6s, axis=0)


source_catalog = {
    "RectangularSource": RectangularSource,
    "MTSource": MTSource,
    "MTQTSource": MTQTSource,
    "DCSource": DCSource,
    "ExplosionSource": ExplosionSource,
    "CLVDSource": CLVDSource,
    "DoubleDCSource": DoubleDCSource,
    "RingfaultSource": RingfaultSource,
}


# ---------------------------------------------------------------------------
# Source time functions (reference stf_catalog, beat/sources.py:723-729)
# ---------------------------------------------------------------------------


def boxcar_stf(t, duration):
    """Unit-area boxcar on [0, duration]."""
    d = jnp.maximum(duration, 1e-6)
    return jnp.where((t >= 0) & (t <= d), 1.0 / d, 0.0)


def triangular_stf(t, duration, peak_ratio=0.5):
    d = jnp.maximum(duration, 1e-6)
    tp = peak_ratio * d
    up = jnp.where((t >= 0) & (t < tp), t / jnp.maximum(tp, 1e-6), 0.0)
    down = jnp.where((t >= tp) & (t <= d), (d - t) / jnp.maximum(d - tp, 1e-6), 0.0)
    return (up + down) * 2.0 / d


def half_sinusoid_stf(t, duration):
    d = jnp.maximum(duration, 1e-6)
    return jnp.where((t >= 0) & (t <= d),
                     jnp.sin(jnp.pi * t / d) * jnp.pi / (2.0 * d), 0.0)


stf_catalog = {
    "Boxcar": boxcar_stf,
    "Triangular": triangular_stf,
    "HalfSinusoid": half_sinusoid_stf,
}


def rectangular_patch_grid(strike, dip, length, width, east_shift,
                           north_shift, depth, n_length: int, n_width: int,
                           anchor: str = "top"):
    """
    Traced patch-center grid of a RectangularSource (reference anchor
    handling ``beat/sources.py:118-157``: the given position is the
    plane's 'top' (top-center), 'center' or 'bottom' point).

    Returns (east, north, depth, along, down): flat (n_length·n_width,)
    arrays; ``along`` measured from the plane center along strike,
    ``down`` from the TOP edge down dip (both [m]) regardless of anchor.
    """
    try:
        anchor_frac = {"top": 0.0, "center": 0.5, "bottom": 1.0}[anchor]
    except KeyError:
        raise ValueError(f"Unknown anchor {anchor!r} (top|center|bottom)")
    st = jnp.deg2rad(strike)
    di = jnp.deg2rad(dip)
    along = ((jnp.arange(n_length) + 0.5) / n_length - 0.5)
    down = (jnp.arange(n_width) + 0.5) / n_width
    along, down = [a.ravel() for a in jnp.meshgrid(along, down)]
    along = along * length
    down = down * width
    down_rel = down - anchor_frac * width   # from the anchored point
    east = east_shift + jnp.sin(st) * along + jnp.cos(di) * jnp.cos(st) * down_rel
    north = north_shift + jnp.cos(st) * along - jnp.cos(di) * jnp.sin(st) * down_rel
    depth_p = depth + jnp.sin(di) * down_rel
    return east, north, depth_p, along, down
