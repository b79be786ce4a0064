"""
Linear Green's-function libraries for distributed-slip (FFI) inversion.

Re-design of ``beat/ffi/base.py``: the reference fills RawArray shared
memory with a fork pool of per-patch pyrocko syntheses and stacks with
pytensor ``batched_dot`` (``stack_all`` :607-709).  Here:

* **Construction** is a ``vmap`` over patch parameter arrays straight
  into HBM (no processes, no shared memory);
* **Stacking** — the kinematic hot kernel — is a fused XLA
  gather + patch reduction over the 5-D tensor
  ``(ntargets, npatches, ndurations, nstarttimes, nsamples)``, with
  nearest-neighbour or multilinear (4-corner) interpolation exactly as
  the reference quantises (``starttimes2idxs``/``durations2idxs``
  :486-568).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger("beat_tpu.ffi.gflibrary")

#: bound on one chain's gathered slab per stacking step.  Measured on
#: an NVIDIA H100 80GB HBM3 at a 400 W power limit, at the Laquila
#: shape (12 targets x 500 patches x 512 samples, 2000 chains):
#: 20-patch blocks (0.49 MB) fuse into the reduction (112 MB
#: temporaries, 60 ms per stack), 50-patch blocks (1.2 MB) do not
#: (2.6 GB, 137 ms), and the unblocked sum needs 98 GB.
STACK_BLOCK_BYTES = 1 << 19


# ---------------------------------------------------------------------------
# Geodetic (static) library
# ---------------------------------------------------------------------------


@dataclass
class GeodeticGFLibrary:
    """
    Static GF matrices per slip component
    (reference ``GeodeticGFLibrary`` ``ffi/base.py:192``): for component c,
    ``gfs[c]`` has shape (npatches, nsamples) and the forward model is
    ``synthetics = Σ_c gfs[c].T @ slips_c`` (``stack_all`` :292-305).
    """

    gfs: dict                      # component -> (npatches, nsamples) jnp array
    component_names: list = field(default_factory=list)

    def __post_init__(self):
        if not self.component_names:
            self.component_names = list(self.gfs.keys())

    @property
    def npatches(self) -> int:
        return next(iter(self.gfs.values())).shape[0]

    @property
    def nsamples(self) -> int:
        return next(iter(self.gfs.values())).shape[1]

    def stack_all(self, **slips):
        """Σ_c G_cᵀ·s_c — one matmul per component."""
        out = 0.0
        for comp, s in slips.items():
            if s is None:
                continue
            out = out + jnp.asarray(self.gfs[comp]).T @ s
        return out

    def save(self, path: str) -> None:
        np.savez_compressed(path, **{c: np.asarray(g) for c, g in self.gfs.items()})

    @classmethod
    def load(cls, path: str) -> "GeodeticGFLibrary":
        with np.load(path) as z:
            gfs = {c: jnp.asarray(z[c]) for c in z.files}
        return cls(gfs=gfs)


def _geolib_flatten(lib: "GeodeticGFLibrary"):
    """Pytree: GF matrices as children so jit takes them as arguments
    (never closure constants); component names static."""
    names = tuple(lib.component_names)
    children = tuple(lib.gfs[c] for c in names)
    return children, names


def _geolib_unflatten(names, children) -> "GeodeticGFLibrary":
    return GeodeticGFLibrary(gfs=dict(zip(names, children)),
                             component_names=list(names))


jax.tree_util.register_pytree_node(GeodeticGFLibrary, _geolib_flatten,
                                   _geolib_unflatten)


def geo_construct_gf_linear(fault, coords, los, components=("uparr", "uperp"),
                            nu=0.25) -> GeodeticGFLibrary:
    """
    Build the static library: unit-slip Okada displacement of every patch,
    LOS-projected (reference ``geo_construct_gf_linear`` ``ffi/base.py:824``
    — fork pool over patches replaced by one vmapped kernel).

    components: 'uparr' = unit slip along patch rake; 'uperp' = rake+90°;
    'utens' = unit opening (reference ``static_dist_vars``
    ``config.py:83``).
    """
    from beat_tpu.heart.okada import okada_surface_displacement

    patches = fault.get_all_patches()
    coords = jnp.asarray(coords)
    los = jnp.asarray(los)

    params = {
        "east_shift": jnp.asarray([p.east_shift for p in patches]),
        "north_shift": jnp.asarray([p.north_shift for p in patches]),
        "depth": jnp.asarray([p.depth for p in patches]),
        "strike": jnp.asarray([p.strike for p in patches]),
        "dip": jnp.asarray([p.dip for p in patches]),
        "rake": jnp.asarray([p.rake for p in patches]),
        "length": jnp.asarray([p.length for p in patches]),
        "width": jnp.asarray([p.width for p in patches]),
    }

    def one_patch(e, n, d, st, di, ra, le, wi, slip, opening):
        disp = okada_surface_displacement(
            coords, east_shift=e, north_shift=n, depth=d, strike=st, dip=di,
            rake=ra, length=le, width=wi, slip=slip, opening=opening,
            nu=nu, anchor="top")
        return jnp.sum(disp * los, axis=-1)

    vm = jax.vmap(one_patch, in_axes=(0,) * 10)
    gfs = {}
    for comp in components:
        if comp == "uparr":
            rake = params["rake"]
            slip, opening = 1.0, 0.0
        elif comp == "uperp":
            rake = params["rake"] + 90.0
            slip, opening = 1.0, 0.0
        elif comp == "utens":
            rake = params["rake"]
            slip, opening = 0.0, 1.0
        else:
            raise ValueError(f"Unknown slip component {comp}")
        n_p = len(patches)
        gfs[comp] = vm(params["east_shift"], params["north_shift"], params["depth"],
                       params["strike"], params["dip"], rake,
                       params["length"], params["width"],
                       jnp.full(n_p, slip), jnp.full(n_p, opening))
    logger.info("Built geodetic GF library: %i patches x %i samples x %s",
                len(patches), coords.shape[0], list(components))
    return GeodeticGFLibrary(gfs=gfs, component_names=list(components))


# ---------------------------------------------------------------------------
# Seismic (kinematic) library
# ---------------------------------------------------------------------------


@dataclass
class SeismicGFLibrary:
    """
    5-D kinematic library (reference ``SeismicGFLibrary``
    ``ffi/base.py:322``): ``data[target, patch, duration, starttime, time]``
    holds tapered/filtered unit-slip synthetics for a grid of source
    durations and rupture-onset times.

    The stacking kernel gathers the (duration, starttime) grid cell per
    (target, patch) and contracts with slips — THE hot op of kinematic FFI
    (reference ``stack_all`` :607: pytensor ``batched_dot``).
    """

    data: jnp.ndarray          # (ntargets, npatches, ndurations, nstarttimes, nsamples)
    duration_min: float
    duration_sampling: float
    starttime_min: float
    starttime_sampling: float
    component: str = "uparr"
    reference_times: np.ndarray | None = None  # (ntargets,) trace start wrt event

    @property
    def ntargets(self):
        return self.data.shape[0]

    @property
    def npatches(self):
        return self.data.shape[1]

    @property
    def ndurations(self):
        return self.data.shape[2]

    @property
    def nstarttimes(self):
        return self.data.shape[3]

    @property
    def nsamples(self):
        return self.data.shape[4]

    # -- index quantisation (reference ffi/base.py:486-568) -----------------

    def durations2idxs(self, durations, interpolation="nearest_neighbor"):
        d = (durations - self.duration_min) / self.duration_sampling
        if interpolation == "nearest_neighbor":
            return jnp.clip(jnp.round(d), 0, self.ndurations - 1).astype(jnp.int32), None
        ceil = jnp.clip(jnp.ceil(d), 1, self.ndurations - 1).astype(jnp.int32)
        factors = ceil - d  # weight of the floor cell
        return ceil, factors

    def starttimes2idxs(self, starttimes, interpolation="nearest_neighbor"):
        s = (starttimes - self.starttime_min) / self.starttime_sampling
        if interpolation == "nearest_neighbor":
            return jnp.clip(jnp.round(s), 0, self.nstarttimes - 1).astype(jnp.int32), None
        ceil = jnp.clip(jnp.ceil(s), 1, self.nstarttimes - 1).astype(jnp.int32)
        factors = ceil - s
        return ceil, factors

    def idxs2durations(self, idxs):
        return idxs * self.duration_sampling + self.duration_min

    def idxs2starttimes(self, idxs):
        return idxs * self.starttime_sampling + self.starttime_min

    # -- the hot kernel -----------------------------------------------------

    def patch_block(self) -> int:
        """Patches stacked per step: the most whose gathered
        (ntargets, block, nsamples) slab of one chain stays within
        :data:`STACK_BLOCK_BYTES`."""
        slab = self.ntargets * self.nsamples * self.data.dtype.itemsize
        return max(1, min(self.npatches, STACK_BLOCK_BYTES // slab))

    def stack_all(self, durations, starttimes, slips,
                  interpolation="nearest_neighbor"):
        """
        Stack all patches for all targets (reference ``stack_all``
        ``ffi/base.py:607-709``).

        durations : (npatches,) STF durations [s]
        starttimes : (ntargets, npatches) onset times incl. per-station
            time shifts [s]
        slips : (npatches,)

        Returns (ntargets, nsamples).

        The patch sum runs in blocks of :meth:`patch_block` patches, so
        that XLA fuses each block's gather into the reduction and never
        materialises the (chains, targets, patches, samples) slab under
        the sampler's vmap.  Plain multiply-and-sum: no matmul, so no
        precision setting applies.
        """
        if interpolation not in ("nearest_neighbor", "multilinear"):
            raise NotImplementedError(f"Interpolation {interpolation}")
        data = jnp.asarray(self.data)
        t_idx = jnp.arange(self.ntargets)[:, None]
        didx, rt_f = self.durations2idxs(durations, interpolation)
        sidx, st_f = self.starttimes2idxs(starttimes, interpolation)

        def block(p0, n):
            def cut(x):
                return jax.lax.dynamic_slice_in_dim(x, p0, n, axis=-1)

            p_idx = (p0 + jnp.arange(n))[None, :]
            d_c, s_c = cut(didx)[None, :], cut(sidx)
            if interpolation == "nearest_neighbor":
                g = data[t_idx, p_idx, d_c, s_c]             # (nt, n, ns)
            else:
                # reference weighting (ffi/base.py:680-698): st_f/rt_f
                # are the floor-cell weights
                rf, sf = cut(rt_f)[None, :], cut(st_f)
                g = (data[t_idx, p_idx, d_c, s_c]
                     * ((1 - sf) * (1 - rf))[..., None]
                     + data[t_idx, p_idx, d_c, s_c - 1]
                     * (sf * (1 - rf))[..., None]
                     + data[t_idx, p_idx, d_c - 1, s_c]
                     * ((1 - sf) * rf)[..., None]
                     + data[t_idx, p_idx, d_c - 1, s_c - 1]
                     * (sf * rf)[..., None])
            return jnp.sum(g * cut(slips)[None, :, None], axis=1)

        pb = self.patch_block()
        n_blocks, rest = divmod(self.npatches, pb)
        out = block(0, pb)
        if n_blocks > 1:
            out = jax.lax.fori_loop(
                1, n_blocks, lambda i, acc: acc + block(i * pb, pb), out)
        if rest:
            out = out + block(n_blocks * pb, rest)
        return out

    # -- persistence (reference save/load ffi/base.py:161-390) ---------------

    def save(self, dirpath: str, name: str) -> None:
        os.makedirs(dirpath, exist_ok=True)
        np.savez_compressed(
            os.path.join(dirpath, f"{name}.npz"),
            data=np.asarray(self.data, dtype=np.float32),
            meta=np.array([self.duration_min, self.duration_sampling,
                           self.starttime_min, self.starttime_sampling]),
            reference_times=(self.reference_times
                             if self.reference_times is not None
                             else np.zeros(self.ntargets)))

    @classmethod
    def load(cls, dirpath: str, name: str, component="uparr") -> "SeismicGFLibrary":
        with np.load(os.path.join(dirpath, f"{name}.npz")) as z:
            meta = z["meta"]
            return cls(data=jnp.asarray(z["data"]),
                       duration_min=float(meta[0]), duration_sampling=float(meta[1]),
                       starttime_min=float(meta[2]), starttime_sampling=float(meta[3]),
                       component=component, reference_times=z["reference_times"])


def _seislib_flatten(lib: "SeismicGFLibrary"):
    """Pytree: the 5-D array is the child (a jit argument, shardable
    over the mesh); grid metadata static."""
    rt = (None if lib.reference_times is None
          else tuple(map(float, np.asarray(lib.reference_times).ravel())))
    aux = (lib.duration_min, lib.duration_sampling, lib.starttime_min,
           lib.starttime_sampling, lib.component, rt)
    return (lib.data,), aux


def _seislib_unflatten(aux, children) -> "SeismicGFLibrary":
    dmin, dsamp, smin, ssamp, component, rt = aux
    return SeismicGFLibrary(
        data=children[0], duration_min=dmin, duration_sampling=dsamp,
        starttime_min=smin, starttime_sampling=ssamp, component=component,
        reference_times=None if rt is None else np.asarray(rt))


jax.tree_util.register_pytree_node(SeismicGFLibrary, _seislib_flatten,
                                   _seislib_unflatten)


def seis_construct_gf_linear(table, wavemap, fault, component="uparr",
                             duration_bounds=(0.5, 4.0), duration_sampling=0.5,
                             starttime_bounds=(0.0, 8.0), starttime_sampling=0.25,
                             shear_modulus=33e9, stf_type="HalfSinusoid",
                             batch_patches: int = 8) -> SeismicGFLibrary:
    """
    Build the 5-D kinematic library from the GF table
    (reference ``seis_construct_gf_linear`` ``ffi/base.py:1067``: fork pool
    over patches → per-duration synthesis → per-starttime chop; here one
    broadcasted frequency-domain product per patch batch on device).

    Grids follow the reference's prior-derived construction
    (``ffi/base.py:1122-1173``): inclusive arange over bounds at the given
    sampling.
    """
    import jax

    from beat_tpu.heart.taper import stf_spectrum_pair
    from beat_tpu.ops.cplx import cexp, cmul, from_np_complex
    from beat_tpu.sources import sdr_to_m6, tensile_m6

    durations = np.arange(duration_bounds[0],
                          duration_bounds[1] + duration_sampling / 2,
                          duration_sampling)
    starttimes = np.arange(starttime_bounds[0],
                           starttime_bounds[1] + starttime_sampling / 2,
                           starttime_sampling)

    patches = fault.get_all_patches()
    npatches = len(patches)
    nwin = wavemap.nsamples_win

    freqs = jnp.asarray(table.freqs)
    w = 2.0 * jnp.pi * freqs
    stf_grid = jnp.stack([stf_spectrum_pair(freqs, float(d), stf_type)
                          for d in durations])                  # (nd, nf, 2)
    phasor_grid = cexp(-w[None, :] * jnp.asarray(starttimes)[:, None])  # (ns, nf, 2)

    station_e = jnp.asarray(wavemap.station_east, dtype=jnp.float32)
    station_n = jnp.asarray(wavemap.station_north, dtype=jnp.float32)
    comp_idx = jnp.asarray(wavemap.comp_idx)
    filt = jnp.asarray(from_np_complex(wavemap.filter_response))
    win_starts = jnp.asarray(wavemap.window_starts)
    taper_win = jnp.asarray(wavemap.taper_window, dtype=jnp.float32)

    # unit-slip moment tensors per patch
    m6s = []
    for p in patches:
        area = p.length * p.width
        if component == "uparr":
            m6s.append(np.asarray(sdr_to_m6(p.strike, p.dip, p.rake,
                                            shear_modulus * area)))
        elif component == "uperp":
            m6s.append(np.asarray(sdr_to_m6(p.strike, p.dip, p.rake + 90.0,
                                            shear_modulus * area)))
        elif component == "utens":
            m6s.append(np.asarray(tensile_m6(p.strike, p.dip, area,
                                             lam=shear_modulus, mu=shear_modulus)))
        else:
            raise ValueError(f"Unknown slip component {component}")
    m6s = jnp.asarray(np.stack(m6s))
    centers = jnp.asarray(np.stack([p.center() for p in patches]))

    def patch_block(m6, center):
        spec = table.point_spectra(m6, center[0], center[1], center[2],
                                   station_e, station_n, comp_idx, filt)  # (nt, nf, 2)
        # (nt, nd, ns, nf, 2)
        full = cmul(cmul(spec[:, None, None], stf_grid[None, :, None]),
                    phasor_grid[None, None, :])
        traces = table.to_time_domain(full)

        def cut(tr_t, start):
            return jax.lax.dynamic_slice(
                tr_t, (0, 0, start), (len(durations), len(starttimes), nwin))

        wins = jax.vmap(cut)(traces, win_starts)
        return wins * taper_win[None, None, None, :]

    # device-resident assembly: synthesize `batch_patches` patches per
    # dispatch and splice them into the preallocated 5-D array in device
    # memory — a GiB-scale library never round-trips through the host
    # (two full-size PCIe transfers)
    batch_block = jax.jit(jax.vmap(patch_block))

    @partial(jax.jit, donate_argnums=(0,))
    def put_blocks(data, blocks, start):
        return jax.lax.dynamic_update_slice(
            data, jnp.swapaxes(blocks, 0, 1).astype(data.dtype),
            (0, start, 0, 0, 0))

    n_targets = int(station_e.shape[0])
    data = jnp.zeros((n_targets, npatches, len(durations), len(starttimes),
                      nwin), dtype=jnp.float32)
    n_b = max(1, int(batch_patches))
    for i0 in range(0, npatches, n_b):
        i1 = min(i0 + n_b, npatches)
        data = put_blocks(data, batch_block(m6s[i0:i1], centers[i0:i1]),
                          i0)

    logger.info("Built seismic GF library '%s': %s", component, data.shape)
    return SeismicGFLibrary(
        data=data,
        duration_min=float(durations[0]), duration_sampling=float(duration_sampling),
        starttime_min=float(starttimes[0]), starttime_sampling=float(starttime_sampling),
        component=component)


def stack_all_numpy(lib: SeismicGFLibrary, durations, starttimes, slips,
                    interpolation="nearest_neighbor"):
    """Host reference implementation for cross-validation
    (mirrors the reference numpy branch of ``stack_all``)."""
    data = np.asarray(lib.data)
    nt, npch = lib.ntargets, lib.npatches
    out = np.zeros((nt, lib.nsamples))
    d = (np.asarray(durations) - lib.duration_min) / lib.duration_sampling
    s = (np.asarray(starttimes) - lib.starttime_min) / lib.starttime_sampling
    for t in range(nt):
        for p in range(npch):
            if interpolation == "nearest_neighbor":
                di = int(np.clip(round(d[p]), 0, lib.ndurations - 1))
                si = int(np.clip(round(s[t, p]), 0, lib.nstarttimes - 1))
                out[t] += data[t, p, di, si, :] * slips[p]
            else:
                dc = int(np.clip(np.ceil(d[p]), 1, lib.ndurations - 1))
                sc = int(np.clip(np.ceil(s[t, p]), 1, lib.nstarttimes - 1))
                fd = dc - d[p]
                fs = sc - s[t, p]
                val = (data[t, p, dc, sc, :] * (1 - fs) * (1 - fd)
                       + data[t, p, dc, sc - 1, :] * fs * (1 - fd)
                       + data[t, p, dc - 1, sc, :] * (1 - fs) * fd
                       + data[t, p, dc - 1, sc - 1, :] * fs * fd)
                out[t] += val * slips[p]
    return out
