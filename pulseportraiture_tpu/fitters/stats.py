"""Sufficient statistics of the extended-FFTFIT likelihood.

The profile-amplitude-marginalized chi-squared of a wideband portrait fit is

    chi2'(theta) = -sum_n C_n(theta)**2 / S_n(theta)        (+ const Sd)

over channels n, where, with harmonics k, data/model rFFTs d, m, scattering
FT B_k(tau_n) = (1 + 2 pi i k tau_n)**-1, phase ramp P_k = e^{2 pi i k phi_n},
and Fourier noise sigma_n:

    C_n = Re sum_k d m* B* P / sigma_n**2      (pptoaslib.py:424-435)
    S_n = sum_k |B|**2 |m|**2 / sigma_n**2     (pptoaslib.py:390-397)

theta = (phi, DM, GM, tau_or_log10tau, alpha).  This module evaluates
chi2' and its analytic gradient and Hessian (pptoaslib.py:525-731) in a
single fused pass, vectorized over channels (no Python loops) and vmappable
over a batch axis.

Implementation notes (differences from the reference that change *speed*,
never *values*):
  * d m* / sigma**2 and |m|**2 / sigma**2 are precomputed once per fit
    (constant across optimizer iterations); each iteration only rebuilds the
    phase ramp and scattering FT.
  * dB/dtau = B(B-1)/tau is evaluated as the algebraically identical
    -2 pi i k B**2, which is division-free and exact at tau = 0; likewise
    d2B/dtau2 = 2(B-1)^2 B / tau^2 = -8 pi^2 k^2 B^3.
  * Masked (zero-weight) channels carry w_n = 0 and contribute exactly zero
    to every sum, keeping shapes static under jit (SURVEY.md section 7).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pulseportraiture_tpu.ops.transform import phase_shifts, phase_shifts_deriv

from pulseportraiture_tpu.config import F0_FACT

import numpy as _np

TWO_PI = float(2.0 * _np.pi)
LN10 = float(_np.log(10.0))


class FitSetup(NamedTuple):
    """Per-fit constants (precomputed once; pytree, vmappable)."""

    Gr: jnp.ndarray     # (nchan, nharm) real: Re[dFT * conj(mFT)]
    Gi: jnp.ndarray     # (nchan, nharm) real: Im[dFT * conj(mFT)]
                        # (split real storage: the Newton loop's
                        # reductions stay in real arithmetic)
    M2: jnp.ndarray     # (nchan, nharm) real: |mFT|**2
    w: jnp.ndarray      # (nchan,) real: 1/errs_FT**2, 0 for dead channels
    freqs: jnp.ndarray  # (nchan,) [MHz]
    P: jnp.ndarray      # scalar period [sec]
    nu_DM: jnp.ndarray  # scalar reference freq for DM term
    nu_GM: jnp.ndarray  # scalar reference freq for GM term
    nu_tau: jnp.ndarray  # scalar reference freq for scattering law
    Sd: jnp.ndarray     # scalar: sum_n w_n sum_k |dFT|**2 (data term)
    S0: jnp.ndarray     # (nchan,) sum_k M2 (unweighted): S/w when
                        # scattering == 0; loop-invariant, multiplied by
                        # the current w at use time so masks stay live
    nbin: int = 0       # true time-domain bin count (2*(nharm-1) only
                        # recovers even nbin; needed for dof)
    kvec: jnp.ndarray = None  # per-lane harmonic numbers when Gr/Gi/M2
                        # are stored in the CT-permuted order of
                        # ops.ct_dft (None = natural 0..nharm-1); every
                        # harmonic reduction is order-free given kvec
    sd_chan: jnp.ndarray = None  # (nchan,) w_n sum_k |dFT|**2: the
                        # per-channel data term (Sd before the channel
                        # sum); lets the fit epilogue emit per-channel
                        # chi2 for ppzap without re-reading the data


def model_ft(model_port, f0_fact=F0_FACT):
    """Precompute the model rFFT as a split (mr, mi) pair for make_setup.

    Production batches share one model portrait across every subint of an
    archive; computing its transform once (outside the per-item vmap)
    removes B-1 redundant transforms and materializes M2 once instead of
    B times."""
    mFT = jnp.fft.rfft(jnp.asarray(model_port), axis=-1)
    mr, mi = mFT.real, mFT.imag
    if not f0_fact:
        mr = mr.at[..., 0].set(0.0)
        mi = mi.at[..., 0].set(0.0)
    return mr, mi


def cross_spectrum(data_port, mr, mi, f0_fact=F0_FACT):
    """(Gr, Gi, sd): split-real G = rfft(data) * conj(m) along the last
    axis, and the per-channel data power sum_k |rfft(data)|**2.

    Any leading batch/channel shape broadcasts against (mr, mi).  The
    DC harmonic is dropped unless f0_fact (reference F0_fact)."""
    dFT = jnp.fft.rfft(data_port, axis=-1)
    dr, di = dFT.real, dFT.imag
    if not f0_fact:
        dr = dr.at[..., 0].set(0.0)
        di = di.at[..., 0].set(0.0)
    return (dr * mr + di * mi, di * mr - dr * mi,
            jnp.sum(dr * dr + di * di, axis=-1))


def make_setup(data_port, model_port, errs, P, freqs, nu_DM, nu_GM, nu_tau,
               weights=None, f0_fact=F0_FACT, model_ft_ri=None,
               stats_dtype=None):
    """Build a FitSetup from time-domain portraits.

    errs: per-channel time-domain noise std (Fourier noise = errs*sqrt(nbin/2),
    reference pptoaslib.py:980-984).  weights: optional 0/1 channel mask.
    model_ft_ri: optional precomputed (mr, mi) from model_ft() — the shared-
    model batched path; model_port is ignored (may be None) when given.
    stats_dtype: storage dtype for the loop-invariant spectra Gr/Gi/M2
    ('bfloat16' halves the Newton loop's read traffic; moments accumulate
    in f32 regardless).  bf16 storage costs ~1e-6 in deterministic phase
    parity — an explicit opt-in, never the default.
    """
    data_port = jnp.asarray(data_port)
    nbin = data_port.shape[-1]
    if model_ft_ri is not None:
        mr, mi = model_ft_ri
    else:
        mr, mi = model_ft(jnp.asarray(model_port), f0_fact=f0_fact)
    Gr, Gi, sd = cross_spectrum(data_port, mr, mi, f0_fact=f0_fact)
    errs_FT = jnp.asarray(errs) * jnp.sqrt(nbin / 2.0)
    w = jnp.where(errs_FT > 0.0, errs_FT ** -2.0, 0.0)
    if weights is not None:
        w = w * (jnp.asarray(weights) > 0.0)
    M2 = mr * mr + mi * mi
    sd_chan = w * sd
    Sd = jnp.sum(sd_chan, axis=-1)
    S0 = jnp.sum(M2, axis=-1)
    if stats_dtype is not None:
        sdt = jnp.dtype(stats_dtype)
        Gr = Gr.astype(sdt)
        Gi = Gi.astype(sdt)
        M2 = M2.astype(sdt)
    dt = data_port.dtype
    return FitSetup(Gr=Gr, Gi=Gi, M2=M2, w=w,
                    freqs=jnp.asarray(freqs, dt),
                    P=jnp.asarray(P, dt), nu_DM=jnp.asarray(nu_DM, dt),
                    nu_GM=jnp.asarray(nu_GM, dt),
                    nu_tau=jnp.asarray(nu_tau, dt),
                    Sd=jnp.asarray(Sd, dt), S0=S0, nbin=int(nbin),
                    sd_chan=sd_chan.astype(dt))


def _taus_and_derivs(params, setup, log10_tau):
    """tau_n, dtau (2, nchan), d2tau (2, 2, nchan).

    Reference: pplib.py:4049-4053, pptoaslib.py:246-274.
    """
    x_tau, alpha = params[3], params[4]
    tau = 10.0 ** x_tau if log10_tau else x_tau
    ratio = setup.freqs / setup.nu_tau
    # guard log for degenerate references (nu_tau = inf when scattering off)
    lr = jnp.log(jnp.where(ratio > 0.0, ratio, 1.0))
    pl = jnp.where(ratio > 0.0, ratio, 1.0) ** alpha
    taus = tau * pl
    if log10_tau:
        dtau_t = LN10 * taus
        d2tau_tt = LN10 * dtau_t
        d2tau_ta = LN10 * lr * taus
    else:
        # reference zeroes these when tau == 0 (pptoaslib.py:251-252, 266-268)
        dtau_t = jnp.where(tau == 0.0, 0.0, pl)
        d2tau_tt = jnp.zeros_like(taus)
        d2tau_ta = jnp.where(tau == 0.0, 0.0, lr * pl)
    dtau_a = lr * taus
    d2tau_aa = lr * dtau_a
    dtau = jnp.stack([dtau_t, dtau_a])
    d2tau = jnp.stack([jnp.stack([d2tau_tt, d2tau_ta]),
                       jnp.stack([d2tau_ta, d2tau_aa])])
    return taus, dtau, d2tau




def _masked_inv(S, w):
    """1/S on channels that are live (w > 0) and have nonzero model
    power; exact zero elsewhere (masked channels contribute nothing)."""
    active = (w > 0.0) & (S != 0.0)
    return jnp.where(active, 1.0 / jnp.where(S != 0.0, S, 1.0), 0.0)


def _phase_trig(phis, k):
    """cos/sin(2 pi phis k), precise in float32 via double-single.

    Naive f32 evaluation of 2 pi phi k loses ~1e-5 rot at k ~ 2000.  For
    f32: wrap phi to [-0.5, 0.5], split into a 13-bit hi (hi*k is exact
    in f32 for k < 2^11) plus a small lo; reduce hi*k mod 1 exactly and
    add lo*k, leaving ~1e-7 rad argument error.  f64 inputs use the
    plain product.
    """
    if phis.dtype == jnp.float64:
        ang = TWO_PI * phis[..., None] * k
        return jnp.cos(ang), jnp.sin(ang)
    p = phis - jnp.round(phis)
    hi = jnp.round(p * 8192.0) / 8192.0
    lo = p - hi
    prod = hi[..., None] * k
    frac = prod - jnp.round(prod)
    ang = TWO_PI * (frac + lo[..., None] * k)
    return jnp.cos(ang), jnp.sin(ang)


def _moments(params, setup, log10_tau, order, scattering=True):
    """Shared harmonic reductions for value/grad/hess.

    order: 0 -> value only, 1 -> + gradient terms, 2 -> + Hessian terms.
    scattering=False (a *static* specialization used when tau is known to
    be identically zero and tau/alpha are not fitted) drops the scattering
    FT and its derivative arrays from the traced graph entirely — the
    common (phi, DM) production path then touches only 3 harmonic
    reductions per evaluation instead of 10, which roughly halves both the
    XLA compile time and the per-iteration HBM traffic.
    Returns a dict of per-channel reductions.
    """
    Gr, Gi, M2, w = setup.Gr, setup.Gi, setup.M2, setup.w
    nharm = Gr.shape[-1]
    dtype = Gr.dtype
    if dtype in (jnp.bfloat16, jnp.float16):
        # half-precision is storage-only; harmonic indices and all
        # accumulation stay f32 (k > 256 is not even representable in
        # bf16)
        dtype = jnp.float32
    kvec = getattr(setup, "kvec", None)
    k = jnp.arange(nharm, dtype=dtype) if kvec is None else \
        jnp.asarray(kvec, dtype)

    phis = phase_shifts(params[0], params[1], params[2], setup.freqs,
                        setup.nu_DM, setup.nu_GM, setup.P, mod=False)
    Pr, Pi = _phase_trig(phis, k)

    if not scattering:
        zero2 = jnp.zeros((2,) + setup.freqs.shape, dtype=dtype)
        zero22 = jnp.zeros((2, 2) + setup.freqs.shape, dtype=dtype)
        out = {
            "phis": phis, "taus": jnp.zeros_like(setup.freqs),
            "dtau": zero2, "d2tau": zero22,
            "S": w * setup.S0,
        }
        zero1 = jnp.zeros_like(setup.freqs)
        zr = Gr * Pr - Gi * Pi
        zi = Gr * Pi + Gi * Pr
        out["C"] = w * jnp.sum(zr, axis=-1)
        if order == 0:
            return out
        phis_d = phase_shifts_deriv(setup.freqs, setup.nu_DM, setup.nu_GM,
                                    setup.P)
        out.update(phis_d=phis_d, Rf=zero1, S1=zero1,
                   Cp=w * (-TWO_PI) * jnp.sum(k * zi, axis=-1))
        if order == 1:
            return out
        out.update(Cpp=w * (-TWO_PI * TWO_PI) * jnp.sum(k * k * zr,
                                                        axis=-1),
                   If1=zero1, Rg=zero1, S2=zero1)
        return out

    taus, dtau, d2tau = _taus_and_derivs(params, setup, log10_tau)

    # B = 1/(1 + i c tau), c = 2 pi k
    ct = TWO_PI * k * taus[..., None]
    Bden = 1.0 + ct * ct
    Br = 1.0 / Bden
    Bi = -ct / Bden

    # z = G * conj(B) * P;  conj(B) = Br - i Bi
    # (Gr + iGi)(Br - iBi) = (GrBr + GiBi) + i(GiBr - GrBi)
    Ar = Gr * Br + Gi * Bi
    Ai = Gi * Br - Gr * Bi
    zr = Ar * Pr - Ai * Pi
    zi = Ar * Pi + Ai * Pr

    B2 = Br * Br + Bi * Bi  # |B|^2
    out = {
        "phis": phis, "taus": taus, "dtau": dtau, "d2tau": d2tau,
        "C": w * jnp.sum(zr, axis=-1),
        "S": w * jnp.sum(B2 * M2, axis=-1),
    }
    if order == 0:
        return out

    phis_d = phase_shifts_deriv(setup.freqs, setup.nu_DM, setup.nu_GM, setup.P)
    out["phis_d"] = phis_d
    # Cphi' = Re sum 2 pi i k z = -2 pi sum k Im z
    out["Cp"] = w * (-TWO_PI) * jnp.sum(k * zi, axis=-1)
    # f = dB/dtau = -2 pi i k B^2   (== B(B-1)/tau, pptoaslib.py:326)
    # zf = G conj(f) P: conj(f) = 2 pi i k conj(B)^2
    # conj(B)^2 = (Br - iBi)^2 = (Br^2 - Bi^2) - 2 i Br Bi
    cb2r = Br * Br - Bi * Bi
    cb2i = -2.0 * Br * Bi
    # conj(f) = 2 pi k * (i cb2) = 2 pi k * (-cb2i + i cb2r)
    cfr = TWO_PI * k * (-cb2i)
    cfi = TWO_PI * k * cb2r
    # zf = (G P) * conj(f); G P = (zr',zi') with conj(B) removed... recompute:
    GPr = Gr * Pr - Gi * Pi
    GPi = Gr * Pi + Gi * Pr
    zfr = GPr * cfr - GPi * cfi
    zfi = GPr * cfi + GPi * cfr
    out["Rf"] = w * jnp.sum(zfr, axis=-1)          # Re sum zf
    # d|B|^2/dtau = 2 Re(B conj(f)) ; (Br + iBi)(cfr + icfi) real part
    u1 = 2.0 * (Br * cfr - Bi * cfi)
    out["S1"] = w * jnp.sum(u1 * M2, axis=-1)
    if order == 1:
        return out

    out["Cpp"] = w * (-TWO_PI * TWO_PI) * jnp.sum(k * k * zr, axis=-1)
    out["If1"] = w * (-TWO_PI) * jnp.sum(k * zfi, axis=-1)  # Re sum 2pi i k zf
    # g2 = d2B/dtau2 = -8 pi^2 k^2 B^3 ; conj(g2) = -8 pi^2 k^2 conj(B)^3
    cb3r = cb2r * Br - cb2i * (-Bi)  # conj(B)^3 = conj(B)^2 * conj(B)
    cb3i = cb2r * (-Bi) + cb2i * Br
    w2k2 = -(TWO_PI ** 2) * 2.0 * k * k
    cgr = w2k2 * cb3r
    cgi = w2k2 * cb3i
    zgr = GPr * cgr - GPi * cgi
    out["Rg"] = w * jnp.sum(zgr, axis=-1)
    # d2|B|^2 terms: u2 = 2(|f|^2 + Re(B conj(g2)))
    f2 = cfr * cfr + cfi * cfi
    u2 = 2.0 * (f2 + (Br * cgr - Bi * cgi))
    out["S2"] = w * jnp.sum(u2 * M2, axis=-1)
    return out


def _grad_stack(m):
    """dC, dS as (5, nchan) from moment reductions.

    Reference: pptoaslib.py:399-409 (Sbp_deriv), 463-480 (Cdbp_deriv).
    """
    phis_d, dtau = m["phis_d"], m["dtau"]
    dC_phase = m["Cp"] * phis_d                      # (3, nchan)
    dC_scat = m["Rf"] * dtau                         # (2, nchan)
    dC = jnp.concatenate([dC_phase, dC_scat], axis=0)
    dS = jnp.concatenate([jnp.zeros_like(dC_phase), m["S1"] * dtau], axis=0)
    return dC, dS


def _hess_stacks(m):
    """d2C, d2S as (5, 5, nchan).  Reference: pptoaslib.py:411-422, 482-523."""
    phis_d, dtau, d2tau = m["phis_d"], m["dtau"], m["d2tau"]
    nchan = phis_d.shape[-1]
    # phase block: Cpp * phis_d_i phis_d_j (phase 2nd derivs are zero)
    pp = phis_d[:, None, :] * phis_d[None, :, :]          # (3,3,nchan)
    d2C_pp = m["Cpp"] * pp
    # scattering block: Rg * dtau_i dtau_j + Rf * d2tau_ij
    tt = dtau[:, None, :] * dtau[None, :, :]              # (2,2,nchan)
    d2C_ss = m["Rg"] * tt + m["Rf"] * d2tau
    # cross block: phis_d_i * (If1 * dtau_j)
    cross = phis_d[:, None, :] * (m["If1"] * dtau)[None, :, :]  # (3,2,nchan)
    top = jnp.concatenate([d2C_pp, cross], axis=1)
    bot = jnp.concatenate([jnp.swapaxes(cross, 0, 1), d2C_ss], axis=1)
    d2C = jnp.concatenate([top, bot], axis=0)
    d2S_ss = m["S2"] * tt + m["S1"] * d2tau
    d2S = jnp.zeros((5, 5, nchan), dtype=d2S_ss.dtype)
    d2S = d2S.at[3:, 3:].set(d2S_ss)
    return d2C, d2S


def chi2_prime(params, setup, log10_tau=True, scattering=True):
    """-sum_n C^2/S (without the constant data term Sd).

    Reference: pptoaslib.py:525-542.
    """
    m = _moments(params, setup, log10_tau, order=0,
                 scattering=scattering)
    si = _masked_inv(m["S"], setup.w)
    return -jnp.sum(m["C"] ** 2 * si)


def chi2_value_grad_hess(params, setup, fit_flags=(1, 1, 1, 1, 1),
                         log10_tau=True, scattering=True,
                         return_moments=False):
    """(chi2', gradient(5,), Hessian(5,5)) in one fused evaluation.

    Gradient: reference pptoaslib.py:544-574; Hessian (amplitude-profiled):
    pptoaslib.py:576-643.  Rows/cols of non-fitted parameters are masked to
    zero (gradient) / identity (Hessian) so a Newton step leaves them fixed.
    return_moments=True appends the moments dict (for epilogue reuse: the
    harmonic reductions depend only on the *physical* per-channel phases
    and taus, which re-referencing preserves, so the zero-covariance
    solver and output covariance need no further pass over Gr/Gi).
    """
    m = _moments(params, setup, log10_tau, order=2,
                 scattering=scattering)
    C, S = m["C"], m["S"]
    si = _masked_inv(S, setup.w)
    r = C * si
    f = -jnp.sum(C * r)

    dC, dS = _grad_stack(m)
    flags = jnp.asarray(fit_flags, dtype=C.dtype)
    # g_j = -sum_n (2 r dC_j - r^2 dS_j)
    g = -jnp.sum(2.0 * r * dC - r * r * dS, axis=-1) * flags

    d2C, d2S = _hess_stacks(m)
    # Hij = -2 sum_n [ r d2C - 0.5 r^2 d2S + dC_i dC_j si + r^2 dS_i dS_j si
    #                  - r (dC_i dS_j + dS_i dC_j) si ]
    dCi_dCj = dC[:, None, :] * dC[None, :, :]
    dSi_dSj = dS[:, None, :] * dS[None, :, :]
    dC_dS = dC[:, None, :] * dS[None, :, :] + dS[:, None, :] * dC[None, :, :]
    Hn = -2.0 * (r * d2C - 0.5 * r * r * d2S + dCi_dCj * si
                 + r * r * dSi_dSj * si - r * dC_dS * si)
    H = jnp.sum(Hn, axis=-1)
    fo = flags[:, None] * flags[None, :]
    H = H * fo + jnp.diag(1.0 - flags)
    if return_moments:
        return f, g, H, m
    return f, g, H


def hess_per_channel_from_moments(m, setup, fit_flags=(1, 1, 1, 1, 1)):
    """Per-channel amplitude-profiled Hessian (5, 5, nchan) from a moments
    dict (no pass over the spectra)."""
    C, S = m["C"], m["S"]
    si = _masked_inv(S, setup.w)
    r = C * si
    dC, dS = _grad_stack(m)
    d2C, d2S = _hess_stacks(m)
    dCi_dCj = dC[:, None, :] * dC[None, :, :]
    dSi_dSj = dS[:, None, :] * dS[None, :, :]
    dC_dS = dC[:, None, :] * dS[None, :, :] + dS[:, None, :] * dC[None, :, :]
    Hn = -2.0 * (r * d2C - 0.5 * r * r * d2S + dCi_dCj * si
                 + r * r * dSi_dSj * si - r * dC_dS * si)
    flags = jnp.asarray(fit_flags, dtype=C.dtype)
    return Hn * (flags[:, None] * flags[None, :])[..., None]


def chi2_hess_per_channel(params, setup, fit_flags=(1, 1, 1, 1, 1),
                          log10_tau=True, scattering=True):
    """Per-channel amplitude-profiled Hessian (5, 5, nchan).

    Used by the zero-covariance frequency solver (pptoaslib.py:733-906).
    """
    m = _moments(params, setup, log10_tau, order=2,
                 scattering=scattering)
    return hess_per_channel_from_moments(m, setup, fit_flags=fit_flags)


def rebase_moments(m, params_out, setup_out, log10_tau, scattering=True):
    """Re-parameterize a moments dict at the output references.

    Re-referencing transports (phi, tau) so that every *physical*
    per-channel phase and tau is unchanged (pptoaslib.py:1052-1065);
    hence all harmonic reductions in m remain valid and only the cheap
    chain-rule factors (phis_d, dtau, d2tau) change with the new
    nu_DM/nu_GM/nu_tau."""
    out = dict(m)
    out["phis_d"] = phase_shifts_deriv(setup_out.freqs, setup_out.nu_DM,
                                       setup_out.nu_GM, setup_out.P)
    if scattering:
        taus, dtau, d2tau = _taus_and_derivs(params_out, setup_out,
                                             log10_tau)
        out.update(taus=taus, dtau=dtau, d2tau=d2tau)
    return out


def covariance_with_scales_from_moments(m, setup, fit_flags=(1, 1, 1, 1, 1)):
    """covariance_with_scales from a precomputed moments dict."""
    return _covariance_core(m, setup, fit_flags)


def get_scales(params, setup, log10_tau=True, scattering=True):
    """Maximum-likelihood per-channel amplitudes a_n = C_n/S_n and S_n.

    Reference: pptoaslib.py:908-926.
    """
    m = _moments(params, setup, log10_tau, order=0,
                 scattering=scattering)
    C, S = m["C"], m["S"]
    si = _masked_inv(S, setup.w)
    return C * si, S


def covariance_with_scales(params, setup, fit_flags=(1, 1, 1, 1, 1),
                           log10_tau=True, scattering=True):
    """(param_cov (5,5), param_errs (5,), scales, scale_errs, channel S).

    The (5+nchan)-parameter covariance (fit params + per-channel amplitudes)
    is inverted blockwise via the Woodbury/LDU identity: the amplitude block
    is diagonal (2 S_n), so only a 5x5 solve is needed.
    Reference: pptoaslib.py:645-731.
    """
    m = _moments(params, setup, log10_tau, order=2,
                 scattering=scattering)
    return _covariance_core(m, setup, fit_flags)


def _covariance_core(m, setup, fit_flags):
    C, S = m["C"], m["S"]
    si = _masked_inv(S, setup.w)
    r = C * si
    dC, dS = _grad_stack(m)
    d2C, d2S = _hess_stacks(m)
    flags = jnp.asarray(fit_flags, dtype=C.dtype)
    fo = flags[:, None] * flags[None, :]

    # Unprofiled fit-param block A (amplitudes explicit, pptoaslib.py:691-697)
    A = jnp.sum(-2.0 * (r * d2C - 0.5 * r * r * d2S), axis=-1) * fo
    A = A + jnp.diag(1.0 - flags)
    # Cross block U_{j,n} = -2 (dC_j - a_n dS_j), masked (pptoaslib.py:690)
    U = -2.0 * (dC - r * dS) * flags[:, None]          # (5, nchan)
    c_inv = si / 2.0                                   # inv of diag(2 S_n)
    hi = jax.lax.Precision.HIGHEST
    X = A - jnp.matmul(U * c_inv, U.T, precision=hi)
    X_inv = jnp.linalg.inv(X)
    param_cov = 2.0 * X_inv * fo
    param_errs = jnp.sqrt(jnp.clip(jnp.diag(param_cov), 0.0))
    # LR block diagonal: 2 (c_inv + c_inv^2 * U^T X_inv U)
    UXU = jnp.einsum("in,ij,jn->n", U, X_inv, U, precision=hi)
    scale_vars = 2.0 * (c_inv + c_inv * c_inv * UXU)
    scale_errs = jnp.sqrt(jnp.clip(scale_vars, 0.0))
    return param_cov, param_errs, r, scale_errs, S
