"""Gaussian profile evaluators (time domain and analytic Fourier domain).

The Fourier evaluator reproduces the reference's sinc-windowed Gaussian FT
(pptoaslib.py:14-50), which requires Re[erf(a + ib)].  JAX has no complex
erf, so we evaluate exp(-b^2) * Re[erf(a + ib)] directly with the
Abramowitz & Stegun 7.1.29 series in an overflow-free form: every
exp(-b^2) * cosh(nb) pairing is rewritten as exp(-(b -/+ n/2)^2) terms, so
the computation is stable for arbitrarily large b (high harmonics / narrow
pulses) where the naive formula overflows.
"""

from __future__ import annotations

import jax.numpy as jnp

from pulseportraiture_tpu.ops.scattering import scattering_profile_FT

_FWHM = 2.0 * jnp.sqrt(2.0 * jnp.log(2.0))  # FWHM = _FWHM * sigma


def _weideman_coeffs(N=64):
    """Taylor coefficients for Weideman's (1994) rational approximation of
    the Faddeeva function w(z) in the upper half-plane (host precompute)."""
    import numpy as np
    M = 2 * N
    M2 = 2 * M
    k = np.arange(-M + 1, M)
    L = np.sqrt(N / np.sqrt(2.0))
    theta = k * np.pi / M
    t = L * np.tan(theta / 2.0)
    f = np.exp(-t ** 2) * (L ** 2 + t ** 2)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / M2
    a = np.flipud(a[1:N + 1])
    return float(L), a


_WEIDEMAN_L, _WEIDEMAN_A = _weideman_coeffs(64)


def _wofz_upper(zr, zi):
    """Faddeeva w(z) = e^{-z^2} erfc(-iz) for Im(z) >= 0, real arithmetic.

    Weideman's rational approximation; ~1e-14 accurate over the upper
    half-plane.  Returns (Re w, Im w), in real arithmetic.
    """
    L = _WEIDEMAN_L
    # iz = -zi + i zr ; L - iz = L + zi - i zr
    dr = L + zi
    di = -zr
    den = dr * dr + di * di
    # Z = (L + iz)/(L - iz)
    nr = L - zi
    ni = zr
    Zr = (nr * dr + ni * di) / den
    Zi = (ni * dr - nr * di) / den
    # Horner evaluation of polynomial in Z with real coefficients
    pr = jnp.zeros_like(Zr)
    pi = jnp.zeros_like(Zi)
    for c in _WEIDEMAN_A:
        pr, pi = pr * Zr - pi * Zi + c, pr * Zi + pi * Zr
    # w = 2 p / (L - iz)^2 + (1/sqrt(pi)) / (L - iz)
    d2r = dr * dr - di * di
    d2i = 2.0 * dr * di
    den2 = d2r * d2r + d2i * d2i
    wr = 2.0 * (pr * d2r + pi * d2i) / den2
    wi = 2.0 * (pi * d2r - pr * d2i) / den2
    inv_sqrt_pi = 0.5641895835477563
    wr = wr + inv_sqrt_pi * dr / den
    wi = wi + inv_sqrt_pi * (-di) / den
    return wr, wi


def _exp_erf_re(a, b):
    """exp(-b^2) * Re[erf(a + i b)] for real a > 0, real b (broadcasting).

    Uses erf(a+ib) = 1 - e^{-(a+ib)^2} w(i(a+ib)), so
    e^{-b^2} Re erf(a+ib) = e^{-b^2} - e^{-a^2} Re[e^{-2iab} w(-b + ia)],
    which is overflow-free for arbitrarily large b (the naive complex-erf
    route, used by the reference via scipy, overflows for b^2 > ~700).
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    a, b = jnp.broadcast_arrays(a, b)
    wr, wi = _wofz_upper(-b, a)
    cos2ab = jnp.cos(2.0 * a * b)
    sin2ab = jnp.sin(2.0 * a * b)
    return jnp.exp(-b * b) - jnp.exp(-a * a) * (cos2ab * wr + sin2ab * wi)


def gaussian_function(xs, loc, wid, norm=False):
    """Gaussian with FWHM wid evaluated at xs.  Reference: pplib.py:752-768."""
    sigma = wid / _FWHM
    zs = (xs - loc) / sigma
    ys = jnp.exp(-0.5 * zs ** 2)
    if norm:
        ys = ys * (sigma ** 2 * 2.0 * jnp.pi) ** -0.5
    return ys


def gaussian_profile(nbin, loc, wid, norm=False, abs_wid=False, zeroout=True):
    """Wraparound-aware Gaussian pulse profile with peak amplitude ~1.

    Matches the reference's behavior (pplib.py:770-825): phase wrapped about
    loc, |z| < 20 support cutoff, zero profile for wid <= 0 (if zeroout),
    and peak renormalization to exactly 1 at the profile maximum when
    norm=False.
    """
    loc = jnp.asarray(loc)
    wid = jnp.asarray(wid)
    if abs_wid:
        wid = jnp.abs(wid)
    dtype = jnp.result_type(loc, wid, float)
    mean = loc % 1.0
    locval = (jnp.arange(nbin, dtype=dtype) + 0.5) / nbin
    locval = jnp.where(mean < 0.5,
                       jnp.where(locval > mean + 0.5, locval - 1.0, locval),
                       jnp.where(locval < mean - 0.5, locval + 1.0, locval))
    safe_wid = jnp.where(wid > 0.0, wid, 1.0) if zeroout else jnp.where(
        wid != 0.0, wid, 1.0)
    sigma = safe_wid / _FWHM
    zs = (locval - mean) / sigma
    vals = jnp.where(jnp.abs(zs) < 20.0,
                     jnp.exp(-0.5 * zs ** 2) / (sigma * jnp.sqrt(2 * jnp.pi)),
                     0.0)
    if not norm:
        imax = jnp.argmax(vals)
        z = (locval[imax] - loc) / sigma
        peak = vals[imax]
        fact = jnp.where(peak > 0.0, jnp.exp(-0.5 * z ** 2) /
                         jnp.where(peak > 0.0, peak, 1.0), 0.0)
        vals = fact * vals
    bad = (wid <= 0.0) if zeroout else (wid == 0.0)
    return jnp.where(bad, jnp.zeros(nbin, dtype=dtype), vals)


def gaussian_profile_FT(nbin, loc, wid, amp):
    """Analytic FT of a Gaussian profile sampled at nbin//2 + 1 harmonics.

    Uses the Fourier shift theorem plus the analytic Gaussian*sinc windowing
    convolution.  Reference: pptoaslib.py:14-50.
    """
    nharm = nbin // 2 + 1
    loc = jnp.asarray(loc)
    wid = jnp.asarray(wid)
    amp = jnp.asarray(amp)
    dtype = jnp.result_type(loc, wid, amp, float)
    safe_wid = jnp.where(wid > 0.0, wid, 1.0)
    sigma_t = safe_wid / _FWHM
    amp_eff = amp * (2.0 * jnp.pi * sigma_t ** 2) ** 0.5
    sigma_f = 1.0 / (2.0 * jnp.pi * sigma_t)
    k = jnp.arange(nharm, dtype=dtype)
    snc = 1.0 / jnp.pi  # half the distance between first sinc zero crossings
    a = sigma_f / (snc * 2.0 ** 0.5)
    b = k / (sigma_f * 2.0 ** 0.5)
    # exp(-b^2) * (erf(a - ib) + erf(a + ib)) / 2 = exp(-b^2)*Re[erf(a + ib)]
    mags = _exp_erf_re(a, b) * amp_eff * nbin
    ramp = jnp.exp(-2.0j * jnp.pi * k * loc)
    out = jnp.nan_to_num(mags * ramp)
    return jnp.where(wid <= 0.0, jnp.zeros(nharm, dtype=out.dtype), out)


def gen_gaussian_profile_FT(params, nbin, applied_scattering=True):
    """FT of a DC + ngauss-Gaussian (+ optional scattering) profile.

    params layout matches the reference (pplib.py:827-851): [dc, tau_bin,
    (loc, wid, amp) * ngauss], tau in [bin].
    """
    ngauss = (len(params) - 2) // 3
    nharm = nbin // 2 + 1
    dc = params[0]
    out = jnp.zeros(nharm, dtype=jnp.result_type(dc, float)).astype(complex)
    out = out.at[0].add(dc * nbin)
    for ig in range(ngauss):
        loc, wid, amp = params[2 + 3 * ig], params[3 + 3 * ig], params[4 + 3 * ig]
        out = out + gaussian_profile_FT(nbin, loc, wid, amp)
    if applied_scattering:
        tau = params[1] / nbin
        out = out * scattering_profile_FT(tau, nbin)
    return out


def instrumental_response_FT(nbin, wid=0.0, irf_type="rect"):
    """FT of the instrumental response (rect sinc or Gaussian).

    Reference: pptoaslib.py:112-143.
    """
    nharm = nbin // 2 + 1
    if irf_type == "rect":
        out = jnp.sinc(jnp.arange(nharm) * wid)
    elif irf_type == "gauss":
        gp = gaussian_profile_FT(nbin, 0.0, wid, 1.0)
        out = gp / gp[0]
    else:
        raise ValueError(f"Unrecognized instrumental response type {irf_type!r}")
    return jnp.where(wid == 0.0, jnp.ones(nharm, dtype=out.dtype), out)


def instrumental_response_port_FT(nbin, freqs, DM=0.0, P=1.0, wids=(),
                                  irf_types=()):
    """Combined instrumental response FT, (nchan, nharm).

    Includes dispersive smearing width 8.3e-6 * chan_bw / (nu/1e3)^3 / P per
    channel when DM != 0.  Reference: pptoaslib.py:145-179.
    """
    import numpy as np
    freqs = np.asarray(freqs)
    nharm = nbin // 2 + 1
    nchan = len(freqs)
    if DM == 0.0 and len(wids) == 0:
        return jnp.ones((nchan, nharm))
    out = jnp.ones((nchan, nharm), dtype=complex)
    for wid, irf_type in zip(wids, irf_types):
        out = out * instrumental_response_FT(nbin, wid, irf_type)[None, :]
    if DM:
        chan_bw = abs(freqs[1] - freqs[0])
        smear_wids = 8.3e-6 * chan_bw / (freqs / 1e3) ** 3 / P
        k = jnp.arange(nharm)
        out = out * jnp.sinc(k[None, :] * jnp.asarray(smear_wids)[:, None])
    return out
