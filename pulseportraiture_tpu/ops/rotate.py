"""Rotation / dedispersion kernels: rFFT -> phase-ramp multiply -> irFFT.

Sign convention (identical to the reference, pplib.py:2433-2434): positive
phase/DM rotate the data to earlier phases, i.e. "dedisperse" for
freqs < nu_ref.  When used to dedisperse, rotate_portrait is virtually
identical to PSRCHIVE's arch.dedisperse() (pplib.py:2436-2437).

Unlike the reference's per-channel Python loops (pplib.py:2450-2459), the
phase ramp is one broadcasted trig array and the whole op batches/vmaps
trivially over any leading dimensions.  All transforms go through
ops.fourier.rotate_ri.
"""

from __future__ import annotations

import jax.numpy as jnp

from pulseportraiture_tpu.config import DCONST
from pulseportraiture_tpu.ops.fourier import rotate_ri
from pulseportraiture_tpu.ops.transform import phase_shifts, _inv2


def rotate_profile(profile, phase=0.0):
    """Rotate a 1-D profile by phase [rot].  Reference: pplib.py:2548-2559."""
    profile = jnp.asarray(profile)
    return rotate_ri(profile, jnp.asarray(phase, dtype=profile.dtype))


def rotate_portrait(port, phase=0.0, DM=None, P=None, freqs=None,
                    nu_ref=jnp.inf, dconst=DCONST):
    """Rotate and/or dedisperse a (..., nchan, nbin) portrait.

    Reference: pplib.py:2428-2460.
    """
    port = jnp.asarray(port)
    if DM is None or freqs is None:
        phis = jnp.asarray(phase, dtype=port.dtype)
        phis = jnp.broadcast_to(phis, port.shape[:-1])
    else:
        D = dconst * DM / P
        phis = phase + D * (_inv2(jnp.asarray(freqs)) - _inv2(nu_ref))
        phis = phis.astype(port.dtype)
    return rotate_ri(port, phis)


def rotate_portrait_full(port, phi, DM, GM, freqs, nu_DM=jnp.inf,
                         nu_GM=jnp.inf, P=None, dconst=DCONST):
    """Rotate with phi + DM + GM simultaneously.

    Reference: pptoaslib.py:52-81.
    """
    port = jnp.asarray(port)
    phis = phase_shifts(phi, DM, GM, jnp.asarray(freqs), nu_DM, nu_GM, P,
                        mod=False, dconst=dconst)
    return rotate_ri(port, phis.astype(port.dtype))


def rotate_data(data, phase=0.0, DM=0.0, Ps=None, freqs=None, nu_ref=jnp.inf,
                dconst=DCONST):
    """Rotate/dedisperse 1-, 2-, or 4-D data.

    data: (nbin,), (nchan, nbin), or (nsub, npol, nchan, nbin).
    Ps: scalar or (nsub,) periods [sec]; freqs: scalar, (nchan,), or
    (nsub, nchan).  Reference: pplib.py:2338-2426.
    """
    data = jnp.asarray(data)
    ndim = data.ndim
    # numeric zero test: int 0 / numpy scalars must take the pure-phase
    # path too (a traced DM never is a python scalar, so this stays
    # jit-safe)
    dm_zero = not hasattr(DM, "dtype") and not isinstance(DM, bool) and \
        isinstance(DM, (int, float)) and float(DM) == 0.0
    if freqs is None or (dm_zero and Ps is None):
        phis = jnp.broadcast_to(jnp.asarray(phase, dtype=data.dtype),
                                data.shape[:-1])
        return rotate_ri(data, phis)

    # Promote to (nsub, npol, nchan, nbin) semantics via broadcasting.
    x = data
    while x.ndim < 4:
        x = x[None]
    nsub, npol, nchan = x.shape[0], x.shape[1], x.shape[2]
    Ps_arr = jnp.broadcast_to(jnp.asarray(Ps, dtype=data.dtype), (nsub,))
    freqs_arr = jnp.asarray(freqs, dtype=data.dtype)
    if freqs_arr.ndim == 0:
        freqs_arr = jnp.broadcast_to(freqs_arr, (nchan,))
    if freqs_arr.ndim == 1:
        freqs_arr = jnp.broadcast_to(freqs_arr, (nsub, nchan))
    D = dconst * DM / Ps_arr  # (nsub,)
    fterm = _inv2(freqs_arr) - _inv2(nu_ref)  # (nsub, nchan)
    phis = phase + D[:, None] * fterm  # (nsub, nchan)
    phis = jnp.broadcast_to(phis[:, None, :], (nsub, npol, nchan))
    out = rotate_ri(x, phis.astype(data.dtype))
    if ndim == 1:
        return out[0, 0, 0]
    if ndim == 2:
        return out[0, 0]
    return out


def fft_rotate(arr, bins):
    """Rotate array left by (possibly fractional) bins; for testing.

    Reference: pplib.py:2561-2575 (PRESTO-style).
    """
    arr = jnp.asarray(arr)
    size = arr.shape[-1]
    return rotate_ri(arr, jnp.asarray(bins, dtype=arr.dtype) / size)


def add_DM_nu(port, phase=0.0, DM=None, P=None, freqs=None, xs=(-2.0,),
              Cs=(1.0,), nu_ref=jnp.inf, dconst=DCONST):
    """Rotate a portrait with an arbitrary power-law dispersion relation.

    freq_term = sum_j C_j * (nu**x_j - nu_ref**x_j); used to simulate
    frequency-dependent DM.  Reference: pplib.py:2509-2546.
    """
    port = jnp.asarray(port)
    if DM is None or freqs is None:
        phis = jnp.broadcast_to(jnp.asarray(phase, dtype=port.dtype),
                                port.shape[:-1])
        return rotate_ri(port, phis)
    freqs = jnp.asarray(freqs, dtype=port.dtype)
    xs = list(xs)
    Cs = list(Cs)
    if len(Cs) < len(xs):
        Cs = Cs + [1.0] * (len(xs) - len(Cs))
    D = dconst * DM / P
    freq_term = jnp.zeros_like(freqs)
    for C, x in zip(Cs, xs):
        ref_term = jnp.where(jnp.isinf(nu_ref),
                             0.0 if x < 0 else jnp.inf, nu_ref ** x)
        freq_term = freq_term + C * (freqs ** x - ref_term)
    phis = phase + D * freq_term
    return rotate_ri(port, phis.astype(port.dtype))


def rotate_portrait_np(port, phase=0.0, DM=0.0, P=None, freqs=None,
                       nu_ref=float("inf"), dconst=DCONST):
    """Host-side float64 mirror of rotate_portrait (numpy).

    Used by the pipelines for precision-critical base rotations: on the
    float32 device path the fit solves for a small residual (phi, dDM)
    around a baseline dispersion that is removed here at full float64
    precision, so phases of many turns never enter the f32 graph.
    """
    import numpy as np
    port = np.asarray(port, dtype=np.float64)
    nbin = port.shape[-1]
    pFFT = np.fft.rfft(port, axis=-1)
    k = np.arange(pFFT.shape[-1])
    if P is not None and freqs is not None:
        D = dconst * DM / P
        inv2 = np.where(np.isinf(freqs), 0.0, np.asarray(freqs,
                                                         np.float64)) ** -2.0
        inv2 = np.where(np.isinf(freqs), 0.0, inv2)
        ref2 = 0.0 if np.isinf(nu_ref) else float(nu_ref) ** -2.0
        phis = phase + D * (inv2 - ref2)
    else:
        phis = np.full(port.shape[-2], float(phase))
    ramp = np.exp(2.0j * np.pi * np.outer(phis, k))
    return np.fft.irfft(pFFT * ramp, n=nbin, axis=-1)
