"""Scattering law and its analytic Fourier-domain representation.

The scattering impulse response is a one-sided exponential with timescale
tau(nu) = tau * (nu/nu_tau)**alpha.  Its analytic FT at harmonic k is
B_k = (1 + 2 pi i k tau)**-1 (tau in [rot]).

Behavioral parity: reference pplib.py:4049-4095 (scattering_times,
scattering_profile_FT, scattering_portrait_FT), pplib.py:1098-1144 (legacy
time-domain kernel, kept for cross-validation tests).
"""

from __future__ import annotations

import jax.numpy as jnp

from pulseportraiture_tpu.config import SCATTERING_ALPHA


def scattering_times(tau, alpha, freqs, nu_tau):
    """tau(nu) = tau * (freqs/nu_tau)**alpha.  Reference: pplib.py:4049-4053."""
    return tau * (freqs / nu_tau) ** alpha


def scattering_profile_FT_ri(tau, nbin, dtype=None):
    """scattering_profile_FT as a split (real, imag) pair — the form the
    fitters' real-arithmetic reductions take.
    B = 1/(1 + i c tau), c = 2 pi k: Br = 1/(1+c^2 tau^2),
    Bi = -c tau/(1+c^2 tau^2)."""
    nharm = nbin // 2 + 1
    tau = jnp.asarray(tau, dtype=dtype)
    k = jnp.arange(nharm, dtype=tau.dtype if dtype is None else dtype)
    ct = 2.0 * jnp.pi * k * tau[..., None] if jnp.ndim(tau) else \
        2.0 * jnp.pi * k * tau
    den = 1.0 + ct * ct
    return 1.0 / den, -ct / den


def scattering_profile_FT(tau, nbin):
    """Analytic FT of the one-sided exponential kernel, nharm samples.

    Returns ones when tau == 0 (no scattering).  tau is in [rot].
    Complex output (host/tests API; device code uses the _ri form).
    Reference: pplib.py:4055-4078.
    """
    nharm = nbin // 2 + 1
    k = jnp.arange(nharm)
    B = (1.0 + 2.0j * jnp.pi * k * tau) ** -1
    return jnp.where(tau == 0.0, jnp.ones(nharm, dtype=B.dtype), B)


def scattering_portrait_FT_ri(taus, nbin):
    """Per-channel split-real scattering FT: (Br, Bi), (..., nchan, nharm)."""
    taus = jnp.asarray(taus)
    nharm = nbin // 2 + 1
    k = jnp.arange(nharm, dtype=taus.dtype)
    ct = 2.0 * jnp.pi * k * taus[..., None]
    den = 1.0 + ct * ct
    return 1.0 / den, -ct / den


def scattering_portrait_FT(taus, nbin):
    """Per-channel stack of scattering_profile_FT: (..., nchan, nharm).

    Reference: pplib.py:4080-4095 (vectorized; no per-channel loop).
    """
    taus = jnp.asarray(taus)
    nharm = nbin // 2 + 1
    k = jnp.arange(nharm, dtype=taus.dtype)
    B = (1.0 + 2.0j * jnp.pi * k * taus[..., None]) ** -1
    return jnp.where(taus[..., None] == 0.0,
                     jnp.ones_like(B), B)


def scattering_portrait_FT_np(taus, nbin):
    """Host numpy mirror of scattering_portrait_FT (complex, float64) for
    simulation/assembly code that immediately materializes the result."""
    import numpy as np
    taus = np.asarray(taus, dtype=np.float64)
    nharm = nbin // 2 + 1
    k = np.arange(nharm)
    B = (1.0 + 2.0j * np.pi * k * taus[..., None]) ** -1
    return np.where(taus[..., None] == 0.0, np.ones_like(B), B)


def scattering_kernel(tau, nu_ref, freqs, phases, P, alpha=SCATTERING_ALPHA):
    """Time-domain one-sided exponential kernel (legacy; for tests).

    Reference: pplib.py:1098-1119.  tau in [sec] or [bin]; phases in [rot]
    (or [bin] if tau is in [bin]); P = 1.0 if tau is in [bin].
    """
    freqs = jnp.asarray(freqs)
    phases = jnp.asarray(phases)
    nchan = freqs.shape[0]
    nbin = phases.shape[0]
    if tau == 0.0:
        sk = jnp.zeros((nchan, nbin))
        return sk.at[:, 0].set(1.0)
    ts = jnp.broadcast_to(phases * P, (nchan, nbin))
    taus = scattering_times(tau, alpha, freqs, nu_ref)
    return jnp.exp(-ts / taus[:, None])


def add_scattering(port, kernel, repeat=3):
    """Convolve port with a scattering kernel, tiled to kill edge effects.

    Reference: pplib.py:1121-1144.  Used only for cross-validation of the
    analytic FT path in tests and simulation.
    """
    from pulseportraiture_tpu.ops.fourier import irfft_ri, rfft_ri

    port = jnp.atleast_2d(jnp.asarray(port))
    kernel = jnp.atleast_2d(jnp.asarray(kernel))
    nbin = port.shape[-1]
    mid = repeat // 2
    d = jnp.tile(port, (1, repeat))
    k = jnp.tile(kernel, (1, repeat))
    norm_kernel = k / k.sum(axis=-1, keepdims=True)
    kr, ki = rfft_ri(norm_kernel)
    dr, di = rfft_ri(d)
    out = irfft_ri(kr * dr - ki * di, kr * di + ki * dr,
                   n=nbin * repeat)
    return out[:, mid * nbin:(mid + 1) * nbin]
