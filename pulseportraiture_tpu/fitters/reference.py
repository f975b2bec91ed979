"""Plain float64 NumPy reference for the fit setup and its moments.

Independent of the device code (complex arithmetic, natural harmonic
order, no split-real tricks): the tests and chip_smoke.py compare the
device setup (stats.make_setup, ops.ct_dft.direct_capped_setup) and
the harmonic reductions (stats._moments) against it.
"""

from __future__ import annotations

import numpy as np

from pulseportraiture_tpu.config import DCONST


def cross_spectrum(data, model, f0_fact=False, scale=None):
    """(G, sd): G = rfft(data) conj(rfft(model)) along the last axis and
    the per-channel data power sum_k |rfft(data)|**2, in float64.

    scale: optional per-channel dequantization multiplying the data.
    The DC harmonic is dropped unless f0_fact."""
    x = np.asarray(data, np.float64)
    if scale is not None:
        x = x * np.asarray(scale, np.float64)[..., None]
    D = np.fft.rfft(x, axis=-1)
    M = np.fft.rfft(np.asarray(model, np.float64), axis=-1)
    if not f0_fact:
        D[..., 0] = 0.0
        M[..., 0] = 0.0
    return D * np.conj(M), (np.abs(D) ** 2).sum(-1)


def moments(params, G, M2, w, freqs, P, nu_DM, nu_GM, nu_tau,
            log10_tau=True, magnitude=False, phis=None, taus=None):
    """Every per-channel harmonic reduction of stats._moments.

    params: (phi, DM, GM, tau or log10 tau, alpha); G: (nchan, nharm)
    complex cross-spectrum; M2: |model FT|**2; w: channel weights.
    Returns a dict C, S, Cp, Cpp, Rf, S1, If1, Rg, S2 of (nchan,).
    magnitude=True sums |term| instead: the scale that float32
    rounding of each sum is proportional to.  phis/taus: per-channel
    phases [rot] and scattering times to use instead of evaluating the
    delay and scattering laws (e.g. a device's float32 values, so that
    only the reductions are compared)."""
    phi, DM, GM, x_tau, alpha = np.asarray(params, np.float64)
    tau = 10.0 ** x_tau if log10_tau else x_tau
    freqs = np.asarray(freqs, np.float64)
    w = np.asarray(w, np.float64)
    M2 = np.asarray(M2, np.float64)
    k = np.arange(G.shape[-1])
    if phis is None:
        phis = phi + DCONST * DM * (freqs ** -2 - nu_DM ** -2) / P + \
            DCONST ** 2 * GM * (freqs ** -4 - nu_GM ** -4) / P
    phis = np.asarray(phis, np.float64)
    Ph = np.exp(2.0j * np.pi * np.outer(phis, k))
    if taus is None:
        taus = tau * (freqs / nu_tau) ** alpha
    taus = np.asarray(taus, np.float64)
    B = 1.0 / (1.0 + 2j * np.pi * np.outer(taus, k))
    f = -2j * np.pi * k * B ** 2                   # dB/dtau
    g2 = -8.0 * np.pi ** 2 * k ** 2 * B ** 3       # d2B/dtau2
    z = G * np.conj(B) * Ph
    zf = G * np.conj(f) * Ph
    zg = G * np.conj(g2) * Ph
    ik = 2j * np.pi * k
    red = {
        "C": np.real(z), "S": np.abs(B) ** 2 * M2, "Cp": np.real(ik * z),
        "Cpp": np.real(ik * ik * z), "Rf": np.real(zf),
        "S1": 2.0 * np.real(B * np.conj(f)) * M2,
        "If1": np.real(ik * zf), "Rg": np.real(zg),
        "S2": 2.0 * (np.abs(f) ** 2 + np.real(B * np.conj(g2))) * M2}
    if magnitude:
        red = {key: np.abs(v) for key, v in red.items()}
    return {key: w * v.sum(-1) for key, v in red.items()}
