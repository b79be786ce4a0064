"""
Real-pair complex arithmetic and DFT-as-matmul.

All frequency-domain math on device uses float32 arrays with a trailing
(re, im) axis, and inverse rFFTs are matmuls against precomputed cos/sin
bases, so the per-target windowing and taper fold into one dense
product.  Whether native complex arithmetic and ``jnp.fft`` are faster
on the GPU is not measured yet.  The basis products are float32
matmuls: the likelihood path runs them at ``HIGHEST`` precision
(:func:`beat_tpu.distributions.pinned_precision`).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def cmul(a, b):
    """Elementwise complex multiply of (re, im)-pair arrays."""
    re = a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1]
    im = a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]
    return jnp.stack([re, im], axis=-1)


def cexp(phase):
    """e^{i·phase} as an (re, im) pair."""
    return jnp.stack([jnp.cos(phase), jnp.sin(phase)], axis=-1)


def creal(a):
    return a[..., 0]


def cimag(a):
    return a[..., 1]


def from_np_complex(x: np.ndarray) -> np.ndarray:
    """numpy complex -> float32 (…, 2) pair array."""
    return np.stack([np.real(x), np.imag(x)], axis=-1).astype(np.float32)


def to_np_complex(pair) -> np.ndarray:
    pair = np.asarray(pair)
    return pair[..., 0] + 1j * pair[..., 1]


def irfft_basis(nt: int) -> tuple:
    """
    (IC, IS) float32 matrices (nf, nt) such that for rfft spectra of a
    real length-``nt`` signal, ``x = re @ IC + im @ IS`` equals
    ``np.fft.irfft(spec, n=nt)``.
    """
    nf = nt // 2 + 1
    k = np.arange(nf)[:, None]
    n = np.arange(nt)[None, :]
    ang = 2.0 * np.pi * k * n / nt
    w = np.full((nf, 1), 2.0)
    w[0] = 1.0
    if nt % 2 == 0:
        w[-1] = 1.0
    IC = (w * np.cos(ang) / nt).astype(np.float32)
    IS = (-w * np.sin(ang) / nt).astype(np.float32)
    return IC, IS


def irfft_pair(pair, IC, IS):
    """Inverse rFFT of (…, nf, 2) pair spectra via basis matmul → (…, nt)."""
    return pair[..., 0] @ IC + pair[..., 1] @ IS


def rfft_basis(nt: int) -> tuple:
    """
    (C, S) float32 matrices (nt, nf) such that for a real signal x,
    ``re = x @ C`` and ``im = x @ S`` equal ``np.fft.rfft(x)``.
    """
    nf = nt // 2 + 1
    n = np.arange(nt)[:, None]
    k = np.arange(nf)[None, :]
    ang = 2.0 * np.pi * n * k / nt
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def amplitude_spectrum(x, C, S):
    """|rfft(x)| of real (…, nt) signals via basis matmuls → (…, nf)."""
    re = x @ C
    im = x @ S
    return jnp.sqrt(re * re + im * im + 1e-30)
