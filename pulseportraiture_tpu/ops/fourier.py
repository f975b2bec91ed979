"""Split-real rFFT helpers.

The fitters and model builders keep spectra as (real, imag) pairs of
real arrays: the Newton loop's reductions then stay in real arithmetic.
These wrappers convert at the jnp.fft boundary.
"""

from __future__ import annotations

import jax.numpy as jnp


def rfft_ri(x):
    """np.fft.rfft along the last axis as a split (real, imag) pair."""
    X = jnp.fft.rfft(x, axis=-1)
    return X.real, X.imag


def irfft_ri(re, im, n=None):
    """np.fft.irfft of a split-real spectrum along the last axis."""
    return jnp.fft.irfft(re + 1j * im, n=n, axis=-1)


def rotate_ri(x, phis):
    """irfft(rfft(x) * e^{+2 pi i k phis}) along the last axis.

    x: (..., nbin) real; phis broadcastable to x.shape[:-1] (rotations).
    The core of every rotation/dedispersion op.
    """
    x = jnp.asarray(x)
    nbin = x.shape[-1]
    re, im = rfft_ri(x)
    k = jnp.arange(re.shape[-1], dtype=re.dtype)
    ang = 2.0 * jnp.pi * jnp.asarray(phis, re.dtype)[..., None] * k
    c, s = jnp.cos(ang), jnp.sin(ang)
    return irfft_ri(re * c - im * s, re * s + im * c, n=nbin)
