"""
Arrival tapers and frequency-domain filters.

Re-design of the reference taper/filter classes (``heart.ArrivalTaper``
:266, ``Filter`` :342) for fixed-shape on-device processing: windows and
filter responses are precomputed host-side as arrays; application on
device is elementwise multiplication (time domain for tapers, rfft
domain for filters), which XLA fuses into the synthesis pipeline.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class ArrivalTaper:
    """
    Cosine taper with corner times (a < b < c < d) relative to the phase
    arrival [s] (reference ``heart.ArrivalTaper``): cos ramp-up a→b, flat
    b→c, cos ramp-down c→d.
    """

    a: float = -15.0
    b: float = -10.0
    c: float = 50.0
    d: float = 55.0

    @property
    def duration(self) -> float:
        return self.d - self.a

    def nsamples(self, dt: float) -> int:
        return int(round(self.duration / dt))

    def window(self, dt: float) -> np.ndarray:
        """Taper amplitude array over the chopped window [a, d)."""
        n = self.nsamples(dt)
        t = self.a + np.arange(n) * dt
        w = np.ones(n)
        up = (t >= self.a) & (t < self.b)
        w[up] = 0.5 - 0.5 * np.cos(np.pi * (t[up] - self.a) / max(self.b - self.a, dt))
        down = (t >= self.c) & (t <= self.d)
        w[down] = 0.5 + 0.5 * np.cos(np.pi * (t[down] - self.c) / max(self.d - self.c, dt))
        w[t > self.d] = 0.0
        return w


@dataclass
class Filter:
    """Butterworth bandpass (reference ``heart.Filter``): applied as a
    frequency response on the rfft of fixed-length traces."""

    lower_corner: float = 0.001
    upper_corner: float = 0.1
    order: int = 4

    def response(self, nsamples: int, dt: float) -> np.ndarray:
        """
        Complex frequency response on the rfft grid of an ``nsamples``
        trace — the digital Butterworth bandpass response (zero-padding
        edge effects are shared by data and synthetics, which pass through
        the identical pipeline).
        """
        from scipy import signal

        nyq = 0.5 / dt
        lo = max(self.lower_corner / nyq, 1e-6)
        hi = min(self.upper_corner / nyq, 1.0 - 1e-6)
        b, a = signal.butter(self.order, [lo, hi], btype="band")
        freqs = np.fft.rfftfreq(nsamples, dt)
        w = freqs / nyq * np.pi
        _, h = signal.freqz(b, a, worN=w)
        return h.astype(np.complex64)


@dataclass
class BandstopFilter(Filter):
    """Reference ``heart.BandstopFilter`` (:383)."""

    lower_corner: float = 0.12
    upper_corner: float = 0.25
    order: int = 4

    def response(self, nsamples: int, dt: float) -> np.ndarray:
        from scipy import signal

        nyq = 0.5 / dt
        lo = max(self.lower_corner / nyq, 1e-6)
        hi = min(self.upper_corner / nyq, 1.0 - 1e-6)
        b, a = signal.butter(self.order, [lo, hi], btype="bandstop")
        freqs = np.fft.rfftfreq(nsamples, dt)
        _, h = signal.freqz(b, a, worN=freqs / nyq * np.pi)
        return h.astype(np.complex64)


@dataclass
class FrequencyFilter:
    """Flat passband with cosine flanks (reference ``heart.FrequencyFilter``
    :402): applied on the amplitude spectrum."""

    freqlimits: tuple = (0.005, 0.01, 0.1, 0.2)

    def response(self, nsamples: int, dt: float) -> np.ndarray:
        f1, f2, f3, f4 = self.freqlimits
        freqs = np.fft.rfftfreq(nsamples, dt)
        h = np.zeros_like(freqs)
        ramp_up = (freqs >= f1) & (freqs < f2)
        h[ramp_up] = 0.5 - 0.5 * np.cos(np.pi * (freqs[ramp_up] - f1) / max(f2 - f1, 1e-9))
        h[(freqs >= f2) & (freqs <= f3)] = 1.0
        ramp_dn = (freqs > f3) & (freqs <= f4)
        h[ramp_dn] = 0.5 + 0.5 * np.cos(np.pi * (freqs[ramp_dn] - f3) / max(f4 - f3, 1e-9))
        return h.astype(np.complex64)


@dataclass
class FilterChain:
    """
    Sequence of frequency-domain filters applied in order — the
    reference's ``WaveformFitConfig.filterer`` is a *list* of filters
    (``config.py:563``, applied successively in ``post_process_trace``
    ``heart.py:3492``); on the rfft grid the responses simply multiply.
    """

    filters: tuple = ()

    def response(self, nsamples: int, dt: float) -> np.ndarray:
        h = np.ones(nsamples // 2 + 1, dtype=np.complex64)
        for f in self.filters:
            h = h * f.response(nsamples, dt)
        return h.astype(np.complex64)


def stf_spectrum_pair(freqs, duration, stf_type: str = "HalfSinusoid"):
    """
    :func:`stf_spectrum` as a real (re, im) pair — the device
    representation of spectra (:mod:`beat_tpu.ops.cplx`).
    """
    import jax.numpy as jnp

    w = 2.0 * jnp.pi * freqs
    d = jnp.maximum(duration, 1e-4)

    if stf_type == "Boxcar":
        mag = jnp.sinc(freqs * d)
        phase = -w * d / 2.0
    elif stf_type == "Triangular":
        mag = jnp.sinc(freqs * d / 2.0) ** 2
        phase = -w * d / 2.0
    elif stf_type == "HalfSinusoid":
        denom = jnp.pi**2 - (w * d) ** 2
        safe = jnp.where(jnp.abs(denom) < 1e-6, 1.0, denom)
        mag = jnp.where(jnp.abs(denom) < 1e-6,
                        jnp.pi / 4.0,
                        jnp.pi**2 * jnp.cos(w * d / 2.0) / safe)
        phase = -w * d / 2.0
    else:
        raise ValueError(f"Unknown STF {stf_type}")
    return jnp.stack([mag * jnp.cos(phase), mag * jnp.sin(phase)], axis=-1)


def stf_spectrum(freqs, duration, stf_type: str = "HalfSinusoid"):
    """
    Analytic source-time-function spectra (unit area), differentiable in
    ``duration`` — replaces discretised STF convolution
    (reference applies pyrocko STFs in ``seis_synthetics``).

    freqs : rfft frequencies [Hz] (jnp array); duration [s] (traced).
    """
    import jax.numpy as jnp

    w = 2.0 * jnp.pi * freqs
    d = jnp.maximum(duration, 1e-4)
    x = w * d / 2.0

    if stf_type == "Boxcar":
        # boxcar centered: sinc, with linear-phase centering delay d/2
        mag = jnp.sinc(freqs * d)  # sin(pi f d)/(pi f d)
        return mag * jnp.exp(-1j * w * d / 2.0)
    elif stf_type == "Triangular":
        mag = jnp.sinc(freqs * d / 2.0) ** 2
        return mag * jnp.exp(-1j * w * d / 2.0)
    elif stf_type == "HalfSinusoid":
        # s(t) = (pi/(2d)) sin(pi t / d) on [0, d]
        # S(w) = (pi^2/ (pi^2 - (w d)^2)) * cos(wd/2) * exp(-i w d/2)
        denom = jnp.pi**2 - (w * d) ** 2
        safe = jnp.where(jnp.abs(denom) < 1e-6, 1.0, denom)
        mag = jnp.where(jnp.abs(denom) < 1e-6,
                        jnp.pi / 4.0,  # limit at w d = pi
                        jnp.pi**2 * jnp.cos(w * d / 2.0) / safe)
        return mag * jnp.exp(-1j * w * d / 2.0)
    raise ValueError(f"Unknown STF {stf_type}")
