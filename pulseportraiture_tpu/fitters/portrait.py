"""Wideband portrait fitters: (phi, DM) and (phi, DM, GM, tau, alpha).

fit_portrait / fit_portrait_full mirror the reference APIs
(pplib.py:2102-2204, pptoaslib.py:928-1096) on top of the shared
sufficient-statistics core (stats.py) and the jit trust-region Newton
optimizer (newton.py).  fit_portrait_full_batch is the production path:
one jitted, vmapped program covering guess -> optimize -> re-reference ->
covariance for a whole batch of subints.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pulseportraiture_tpu.config import DCONST
from pulseportraiture_tpu.fitters import newton, nu_zeros, stats
from pulseportraiture_tpu.ops.noise import get_noise_PS
from pulseportraiture_tpu.ops.scattering import scattering_times
from pulseportraiture_tpu.ops.transform import (mod_pm_half, phase_shifts,
                                                _inv2, _inv4)
from pulseportraiture_tpu.utils import DataBunch


class PortraitFitResult(NamedTuple):
    """Pytree result of a 5-parameter fit (vmappable)."""

    params: jnp.ndarray        # (5,) [phi_out, DM, GM, tau_out, alpha]
    param_errs: jnp.ndarray    # (5,)
    scales: jnp.ndarray        # (nchan,)
    scale_errs: jnp.ndarray    # (nchan,)
    nu_DM: jnp.ndarray
    nu_GM: jnp.ndarray
    nu_tau: jnp.ndarray
    covariance_matrix: jnp.ndarray  # (5,5) masked to fitted params
    chi2: jnp.ndarray
    red_chi2: jnp.ndarray
    snr: jnp.ndarray
    channel_snrs: jnp.ndarray
    niter: jnp.ndarray
    nfeval: jnp.ndarray
    return_code: jnp.ndarray
    channel_red_chi2: jnp.ndarray = None  # (nchan,) per-channel
    # reduced chi2 at the fitted solution: (sd_n - a_n^2 S_n)/(nbin-2),
    # Fourier-domain with the DC harmonic excluded (F0_FACT zeroing) --
    # the on-device analogue of the reference's time-domain per-channel
    # get_red_chi2 in the zap pass (pptoas.py:1208-1285); feeds
    # GetTOAs.get_channels_to_zap without re-reading any archive

    @property
    def phi(self):
        return self.params[..., 0]

    @property
    def DM(self):
        return self.params[..., 1]

    @property
    def GM(self):
        return self.params[..., 2]

    @property
    def tau(self):
        return self.params[..., 3]

    @property
    def alpha(self):
        return self.params[..., 4]

    @property
    def phi_err(self):
        return self.param_errs[..., 0]

    @property
    def DM_err(self):
        return self.param_errs[..., 1]

    @property
    def GM_err(self):
        return self.param_errs[..., 2]

    @property
    def tau_err(self):
        return self.param_errs[..., 3]

    @property
    def alpha_err(self):
        return self.param_errs[..., 4]


@functools.partial(jax.jit,
                   static_argnames=("fit_flags", "log10_tau", "max_iter",
                                    "scattering"))
def _optimize(init_params, setup, fit_flags, log10_tau, max_iter=100,
              gtol=1e-11, xtol=1e-14, scattering=True):
    def fgh(x):
        return stats.chi2_value_grad_hess(x, setup, fit_flags=fit_flags,
                                          log10_tau=log10_tau,
                                          scattering=scattering,
                                          return_moments=True)

    return newton.trust_region_minimize(fgh, init_params, max_iter=max_iter,
                                        gtol=gtol, xtol=xtol, has_aux=True,
                                        step_mask=fit_flags)


def _rereference(params, setup, nu_out_DM, nu_out_GM, nu_out_tau,
                 log10_tau, dconst=DCONST):
    """Transport fitted (phi, tau) to the output reference frequencies.

    Reference: pptoaslib.py:1052-1065.
    """
    phi_fit, DM_fit, GM_fit = params[0], params[1], params[2]
    x_tau, alpha = params[3], params[4]
    P = setup.P
    phi_inf = phase_shifts(phi_fit, DM_fit, GM_fit, jnp.inf, setup.nu_DM,
                           setup.nu_GM, P, mod=False, dconst=dconst)
    phi_out = phi_inf + (dconst / P) * DM_fit * _inv2(nu_out_DM) + \
        (dconst ** 2 / P) * GM_fit * _inv4(nu_out_GM)
    phi_out = mod_pm_half(phi_out)
    tau_fit = 10.0 ** x_tau if log10_tau else x_tau
    tau_out = scattering_times(tau_fit, alpha, nu_out_tau, setup.nu_tau)
    x_tau_out = jnp.log10(jnp.where(tau_out > 0.0, tau_out, 1.0)) \
        if log10_tau else tau_out
    if log10_tau:
        x_tau_out = jnp.where(tau_out > 0.0, x_tau_out, -jnp.inf)
    return jnp.stack([phi_out, DM_fit, GM_fit, x_tau_out, alpha])


@functools.partial(jax.jit, static_argnames=("fit_flags", "log10_tau",
                                              "scattering"))
def _finalize(params_out, setup_out, fit_flags, log10_tau, fun,
              scattering=True, moments=None):
    """Covariance, scales, SNR, chi2 at the output reference.

    moments: the optimizer's final reductions dict; when given, the
    covariance is derived from it (rebased to the output references)
    without another pass over Gr/Gi — valid because re-referencing
    preserves the physical per-channel phases/taus (stats.rebase_moments).
    """
    if moments is not None:
        m_out = stats.rebase_moments(moments, params_out, setup_out,
                                     log10_tau, scattering=scattering)
        cov, perrs, scales, scale_errs, S = \
            stats.covariance_with_scales_from_moments(
                m_out, setup_out, fit_flags=fit_flags)
    else:
        cov, perrs, scales, scale_errs, S = stats.covariance_with_scales(
            params_out, setup_out, fit_flags=fit_flags, log10_tau=log10_tau,
            scattering=scattering)
    channel_snrs = scales * jnp.sqrt(jnp.clip(S, 0.0))
    snr = jnp.sqrt(jnp.sum(channel_snrs ** 2))
    chi2 = setup_out.Sd + fun
    active = setup_out.w > 0.0
    nbin_eff = jnp.where(jnp.asarray(setup_out.nbin) > 0, setup_out.nbin,
                         2 * (setup_out.Gr.shape[-1] - 1))
    nfit = sum(int(bool(f)) for f in fit_flags)
    dof = jnp.sum(active) * nbin_eff - (nfit + jnp.sum(active))
    red_chi2 = chi2 / dof
    # per-channel reduced chi2 at the fitted amplitudes (for ppzap):
    # chi2_n = sd_n - C_n^2/S_n = sd_n - a_n^2 S_n; dof = nbin - 2
    # (scale + the shared shift), matching the reference's per-channel
    # get_red_chi2 convention (pptoas.py:1246) in the Fourier domain
    # with DC excluded.
    if setup_out.sd_chan is not None:
        # clamp to a tiny positive floor on live channels: rounding can
        # push a perfectly-fit channel's chi2 to <= 0, and downstream
        # (get_channels_to_zap) uses "exactly 0" to mean dead channel
        ch_chi2 = jnp.maximum(setup_out.sd_chan - scales * scales * S,
                              1e-30)
        channel_red_chi2 = jnp.where(active,
                                     ch_chi2 / (nbin_eff - 2), 0.0)
    else:
        channel_red_chi2 = jnp.zeros_like(scales)
    return (cov, perrs, scales, scale_errs, channel_snrs, snr, chi2,
            red_chi2, channel_red_chi2)


def fit_portrait_full(data_port, model_port, init_params, P, freqs,
                      nu_fits=(None, None, None), nu_outs=(None, None, None),
                      errs=None, fit_flags=(1, 1, 1, 1, 1), bounds=None,
                      log10_tau=True, option=0, sub_id=None,
                      method="trust-ncg", is_toa=True, quiet=True,
                      scattering=None):
    """Fit phi, DM, GM, tau, alpha between data and model portraits.

    Mirrors reference pptoaslib.py:928-1096.  `method` and `bounds` are
    accepted for API compatibility; the optimizer is always the exact
    trust-region Newton (tighter convergence than any reference mode).
    """
    data_port = jnp.asarray(data_port)
    model_port = jnp.asarray(model_port)
    freqs = jnp.asarray(freqs)
    fit_flags = tuple(int(bool(f)) for f in fit_flags)
    # static no-scattering specialization: only safe when the caller
    # guarantees tau is identically zero (tau/alpha unfitted forces it on)
    if fit_flags[3] or fit_flags[4]:
        scattering = True
    elif scattering is None:
        scattering = True
    if errs is None:
        errs = get_noise_PS(data_port, chans=True)
    nu_fit_DM, nu_fit_GM, nu_fit_tau = [
        jnp.asarray(nf) if nf is not None else freqs.mean() for nf in nu_fits]

    setup = stats.make_setup(data_port, model_port, errs, P, freqs,
                             nu_fit_DM, nu_fit_GM, nu_fit_tau)
    start = time.time()
    res = _optimize(jnp.asarray(init_params, dtype=data_port.dtype), setup,
                    fit_flags, log10_tau, scattering=scattering)
    jax.block_until_ready(res.x)  # duration must measure the solve
    duration = time.time() - start

    # zero-covariance output references (host closed forms / polynomials)
    nu_out_DM, nu_out_GM, nu_out_tau = nu_outs
    if not all(n is not None for n in nu_outs):
        nz_DM, nz_GM, nz_tau = nu_zeros.get_nu_zeros(
            res.x, setup, fit_flags=fit_flags, log10_tau=log10_tau,
            option=option, scattering=scattering, moments=res.aux)
        if nu_out_DM is None:
            nu_out_DM = nz_DM
        if nu_out_GM is None:
            nu_out_GM = nz_GM
        if nu_out_tau is None:
            nu_out_tau = nz_tau
    nu_out_DM = jnp.asarray(nu_out_DM)
    nu_out_GM = jnp.asarray(nu_out_GM)
    nu_out_tau = jnp.asarray(nu_out_tau)
    if is_toa:  # phi must be a TOA-compatible shift (pptoaslib.py:1048-1050)
        if fit_flags[1]:
            nu_out_GM = nu_out_DM
        elif fit_flags[2]:
            nu_out_DM = nu_out_GM

    params_out = _rereference(res.x, setup, nu_out_DM, nu_out_GM, nu_out_tau,
                              log10_tau)
    setup_out = setup._replace(nu_DM=nu_out_DM, nu_GM=nu_out_GM,
                               nu_tau=nu_out_tau)
    (cov, perrs, scales, scale_errs, channel_snrs, snr, chi2, red_chi2,
     ch_rchi2) = \
        _finalize(params_out, setup_out, fit_flags, log10_tau, res.fun,
                  scattering=scattering, moments=res.aux)

    return PortraitFitResult(
        params=params_out, param_errs=perrs, scales=scales,
        scale_errs=scale_errs, nu_DM=nu_out_DM, nu_GM=nu_out_GM,
        nu_tau=nu_out_tau, covariance_matrix=cov, chi2=chi2,
        red_chi2=red_chi2, snr=snr, channel_snrs=channel_snrs,
        niter=res.niter, nfeval=res.nfev, return_code=res.status,
        channel_red_chi2=ch_rchi2), duration


def fit_portrait(data, model, init_params, P, freqs, nu_fit=None, nu_out=None,
                 errs=None, bounds=None, id=None, quiet=True):
    """Fit a phase offset and DM between data and model portraits.

    2-parameter specialization; mirrors reference pplib.py:2102-2204,
    including its scale_errs = sqrt(S)^-1 convention.
    """
    data = jnp.asarray(data)
    freqs = jnp.asarray(freqs)
    if errs is None:
        errs = get_noise_PS(data, chans=True)
    if nu_fit is None:
        nu_fit = freqs.mean()
    fit_flags = (1, 1, 0, 0, 0)
    init5 = jnp.asarray([init_params[0], init_params[1], 0.0, 0.0, 0.0],
                        dtype=data.dtype)
    setup = stats.make_setup(data, model, errs, P, freqs, nu_fit, jnp.inf,
                             nu_fit)
    start = time.time()
    res = _optimize(init5, setup, fit_flags, False, scattering=False)
    jax.block_until_ready(res.x)
    duration = time.time() - start

    nz = nu_zeros.get_nu_zeros(res.x, setup, fit_flags=fit_flags,
                               log10_tau=False, scattering=False,
                               moments=res.aux)
    nu_zero = nz[0]
    nu_out = nu_zero if nu_out is None else jnp.asarray(nu_out)
    params_out = _rereference(res.x, setup, nu_out, jnp.inf, jnp.inf, False)
    setup_out = setup._replace(nu_DM=nu_out)
    # the Hessian at the re-referenced point from the optimizer's final
    # reductions (physical phases unchanged; only phis_d changes)
    m_out = stats.rebase_moments(res.aux, params_out, setup_out, False,
                                 scattering=False)
    Hn = stats.hess_per_channel_from_moments(m_out, setup_out,
                                             fit_flags=fit_flags)
    H2 = Hn.sum(axis=-1)[:2, :2]
    cov2 = jnp.linalg.inv(0.5 * H2)
    param_errs = jnp.sqrt(jnp.clip(jnp.diag(cov2), 0.0))
    # scales evaluated at the fit reference (reference pplib.py:2195)
    si = stats._masked_inv(res.aux["S"], setup.w)
    scales, S = res.aux["C"] * si, res.aux["S"]
    scale_errs = jnp.where(S > 0.0, jnp.where(S > 0.0, S, 1.0) ** -0.5, 0.0)
    channel_snrs_sq = scales ** 2 * S
    snr = jnp.sqrt(jnp.sum(channel_snrs_sq))
    chi2 = setup.Sd + res.fun
    active = setup.w > 0.0
    nbin = data.shape[-1]
    dof = nbin * jnp.sum(active) - (jnp.sum(active) + 2)
    red_chi2 = chi2 / dof
    return DataBunch(phase=params_out[0], phase_err=param_errs[0],
                     DM=params_out[1], DM_err=param_errs[1], scales=scales,
                     scale_errs=scale_errs, nu_ref=nu_out,
                     covariance=cov2[0, 1], chi2=chi2, red_chi2=red_chi2,
                     snr=snr, duration=duration, nfeval=res.nfev,
                     return_code=res.status)


# ----------------------------------------------------------------------
# Batched production path
# ----------------------------------------------------------------------

def _brute_phase_seed(gsr, gsi, kvec, Ns=512):
    """Per-item brute phase from the band-summed cross-spectrum.

    argmax_phi sum_k Re(Gsum_k e^{2 pi i phi k}) — the phi-only profile
    of the fit objective at the init DM — evaluated on an Ns-point
    circular grid (one (B, NH) @ (NH, Ns) matmul) and refined with a
    3-point parabola through the peak (seed error ~(1/Ns)^2; the Newton
    loop then converges in 1-2 iterations).  Fed from the band sums the
    setup already computes (ops.ct_dft.direct_capped_setup(..., w=),
    parallel.mesh), it costs no extra pass over the spectra.
    """
    dt = gsr.dtype
    grid = jnp.arange(Ns, dtype=dt) / Ns - 0.5          # circular
    Ct, St = stats._phase_trig(grid, jnp.asarray(kvec, dt))  # (Ns, NH)
    hi = jax.lax.Precision.HIGHEST
    vals = jnp.matmul(gsr, Ct.T, precision=hi) - \
        jnp.matmul(gsi, St.T, precision=hi)             # (B, Ns)
    j = jnp.argmax(vals, axis=-1)
    B = vals.shape[0]
    rows = jnp.arange(B)
    vm = vals[rows, (j - 1) % Ns]
    v0 = vals[rows, j]
    vp = vals[rows, (j + 1) % Ns]
    denom = vm - 2.0 * v0 + vp
    delta = jnp.where(denom < 0.0, 0.5 * (vm - vp) / denom, 0.0)
    return grid[j] + jnp.clip(delta, -0.5, 0.5) / Ns


def _seed_phi_dm(gsr, gsi, kvec, wcurv, beta, kdm, Ns=512,
                 max_dphi=0.1):
    """Joint brute (phi, DM) seed from stacked band-summed cross-spectra.

    gsr/gsi: (B, 2, NH) — seed accumulators for the weight stack
    [full band, upper half-band] (direct_capped_setup stacked-w outputs).
    The lower-half spectrum is their difference, so three brute phase
    profiles cost ONE (3B, NH) @ (NH, Ns) matmul.  Each half-band
    argmax estimates the fit shift at that half's curvature-weighted
    effective dispersion delay beta_eff (wcurv ~ w_c * sum_k k^2
    |m_ck|^2 — the curvature of the per-channel correlation peak, so
    the band-summed argmax sits at the wcurv-weighted mean of the
    per-channel shifts); the wrapped difference over
    kdm*(beta_hi - beta_lo) is the DM seed, and the full-band phase is
    rebased to the fit's phase parameter at beta = 0.

    Robustness: multi-peaked templates can alias a HALF-band argmax to
    a secondary correlation lobe under noise, which would catapult the
    DM seed; any |phi_hi - phi_lo| > max_dphi (default 0.1 turns —
    far beyond any dedispersed residual-DM differential) falls back to
    (phi_full, 0), i.e. the plain phase seed.  The seed only moves the
    Newton start, never the optimum.
    """
    B, _, NH = gsr.shape
    g3r = jnp.concatenate([gsr[:, 0], gsr[:, 1], gsr[:, 0] - gsr[:, 1]],
                          axis=0)
    g3i = jnp.concatenate([gsi[:, 0], gsi[:, 1], gsi[:, 0] - gsi[:, 1]],
                          axis=0)
    ph = _brute_phase_seed(g3r, g3i, kvec, Ns=Ns)
    phi_full, phi_hi, phi_lo = ph[:B], ph[B:2 * B], ph[2 * B:]
    nchan = beta.shape[-1]
    hi = jnp.arange(nchan) >= nchan // 2
    w_hi = jnp.where(hi[None, :], wcurv, 0.0)
    w_lo = wcurv - w_hi

    def eff(wm):
        s = jnp.sum(wm, axis=-1)
        return jnp.sum(wm * beta, axis=-1) / jnp.where(s > 0.0, s, 1.0), s

    b_full, s_full = eff(wcurv)
    b_hi, s_hi = eff(w_hi)
    b_lo, s_lo = eff(w_lo)
    dphi = mod_pm_half(phi_hi - phi_lo)
    dbeta = kdm * (b_hi - b_lo)
    ok = (jnp.abs(dbeta) > 1e-30) & (s_hi > 0.0) & (s_lo > 0.0) & \
        (jnp.abs(dphi) < max_dphi)
    dm0 = jnp.where(ok, dphi / jnp.where(ok, dbeta, 1.0), 0.0)
    phi0 = mod_pm_half(phi_full - kdm * dm0 * b_full)
    return phi0, dm0


@functools.partial(jax.jit,
                   static_argnames=("fit_flags", "log10_tau", "max_iter",
                                    "scattering", "dft_precision",
                                    "stats_dtype", "ct", "seed_phase",
                                    "seed_dm", "mharm"))
def fit_portrait_full_batch(data_ports, model_ports, init_params, Ps, freqs,
                            errs, weights=None,
                            nu_fits=None, fit_flags=(1, 1, 0, 0, 0),
                            log10_tau=True, max_iter=100,
                            scattering=None, dft_precision="highest",
                            stats_dtype=None, ct=False,
                            seed_phase=False, seed_dm=False, scales=None,
                            model_ft_ri=None, mharm=None):
    """Fully-jitted batched 5-parameter fit over a leading batch axis.

    data_ports: (B, nchan, nbin); model_ports: (B, nchan, nbin), or
    (nchan, nbin) when every item shares one model — the shared-model
    fast path computes the model rFFT and M2 once instead of B times
    (the production case: one template per archive).  Ps: (B,); freqs:
    (B, nchan) or (nchan,); errs: (B, nchan); weights: optional
    (B, nchan) mask.  nu_fits: (B, 3) or None (defaults to per-item
    mean frequency).

    The default setup is the natural-order, full-band rFFT cross-
    spectrum (stats.make_setup) per item.

    scales: optional (B, nchan) per-channel dequantization scales for
    int16 data_ports (int16-native ingest: the archive's DAT_SCL stays
    host-side and the quantized samples upload at half the bytes; the
    per-channel offsets only feed the DC harmonic, which F0_FACT
    zeroing discards — requires config.F0_FACT falsy).

    seed_phase=True overwrites init_params[:, 0] with a brute phase
    guess computed in-program (from the band-summed cross-spectrum on
    the capped path, from the channel-mean profiles otherwise) — the
    production seeding, without a separate device dispatch.

    seed_dm=True (capped path, requires seed_phase and fit_flags[1])
    additionally overwrites init_params[:, 1] with a brute DM guess
    from the wrapped phase difference of the two half-band summed
    cross-spectra (_seed_phi_dm); it typically saves a Newton
    iteration (the vmapped loop runs max-over-batch iterations).

    model_ft_ri: optional precomputed natural-order split-real model
    spectrum (re, im), each (nchan, nharm) — pass a HOST float64 rFFT
    cast to f32 for the best accuracy (and genuine zeros where the
    model band ends).  Requires the shared 2-D model path.

    ct=True selects the capped setup (ops.ct_dft.direct_capped_setup):
    only harmonics k < NQ*mharm are stored and streamed, in CT-permuted
    order — exact (to f32 rounding) whenever the model spectrum is
    identically zero above (ops.ct_dft.band_cap_model_ft).  It needs
    the shared 2-D model and the static cap `mharm`; dft_precision
    ("high" or "highest", ops.ct_dft.dot_precision) sets its DFT matmul
    precision.  Off the capped path mharm is ignored.

    Output references use the closed-form zero-covariance branches (the
    polynomial GM branches are host-only; batched GM fits re-reference at
    nu_fit).  Returns a PortraitFitResult with leading batch dims.
    """
    if fit_flags[3] or fit_flags[4]:
        scattering = True
    elif scattering is None:
        scattering = True
    B = data_ports.shape[0]
    if scales is not None:
        from pulseportraiture_tpu.config import F0_FACT
        assert not F0_FACT, "int16 ingest requires F0_FACT zeroing"
        scales = jnp.broadcast_to(
            jnp.asarray(scales, jnp.float32), data_ports.shape[:2])
    if freqs.ndim == 1:
        freqs = jnp.broadcast_to(freqs, (B,) + freqs.shape)
    if nu_fits is None:
        nu_fits = jnp.broadcast_to(freqs.mean(axis=-1)[:, None], (B, 3))
    if weights is None:
        weights = jnp.ones_like(errs)

    if ct:
        if mharm is None or model_ports.ndim != 2:
            raise ValueError("ct=True (the capped setup) needs the shared "
                             "2-D model and a model-band cap mharm")
    elif scales is not None:
        # dequantize up front (the capped setup instead scales after
        # its DFT matmul)
        data_ports = data_ports.astype(jnp.float32) * scales[..., None]
        scales = None
    shared_mft = None
    if model_ft_ri is not None:
        assert model_ports.ndim == 2, \
            "model_ft_ri requires the shared 2-D model path"
        shared_mft = (jnp.asarray(model_ft_ri[0]).astype(jnp.float32),
                      jnp.asarray(model_ft_ri[1]).astype(jnp.float32))
    elif model_ports.ndim == 2:
        # one rFFT for the whole batch; M2/S0 materialize once under vmap
        shared_mft = stats.model_ft(model_ports)

    _fit_one = _make_fit_one(fit_flags, log10_tau, max_iter, scattering)

    nbin = data_ports.shape[-1]
    if ct:
        # capped setup: one direct DFT matmul over the kept harmonics
        # builds the CT-permuted Gr/Gi and the per-channel data power;
        # the shared model/M2 are never materialized per item
        from pulseportraiture_tpu.config import F0_FACT
        from pulseportraiture_tpu.ops.ct_dft import (ct_kvec,
                                                     direct_capped_setup,
                                                     permute_spectrum)
        mrp, mip = permute_spectrum(shared_mft[0], shared_mft[1], nbin,
                                    mharm=mharm)
        dt = jnp.float32 if scales is not None else data_ports.dtype
        errs_FT = errs.astype(dt) * jnp.sqrt(jnp.asarray(nbin / 2.0, dt))
        w = jnp.where(errs_FT > 0.0, errs_FT ** -2.0, 0.0)
        w = w * (weights > 0.0)
        kvec = jnp.asarray(ct_kvec(nbin, mharm=mharm), dt)
        setup_fn = functools.partial(direct_capped_setup, mharm=mharm,
                                     dft_precision=dft_precision,
                                     f0_fact=bool(F0_FACT), scale=scales)
        M2 = mrp * mrp + mip * mip
        _seed_dm = bool(seed_dm) and seed_phase and bool(fit_flags[1])
        if _seed_dm:
            # stacked [full-band, upper-half] seed weights: the second
            # band sum gives the joint (phi, DM) brute seed
            nchan_ = data_ports.shape[1]
            hi_mask = (jnp.arange(nchan_) >= nchan_ // 2).astype(
                jnp.float32)
            w_seed = jnp.stack([w, w * hi_mask[None, :]], axis=-1)
            Grp, Gip, sd, gsr, gsi = setup_fn(data_ports, mrp, mip,
                                              w=w_seed)
            wcurv = w * jnp.sum(M2 * kvec * kvec, axis=-1)[None, :]
            beta = freqs.astype(dt) ** -2.0 - \
                (nu_fits[:, 0].astype(dt) ** -2.0)[:, None]
            kdm = jnp.asarray(DCONST, dt) / Ps.astype(dt)
            phi0, dm0 = _seed_phi_dm(gsr, gsi, kvec, wcurv, beta, kdm)
            init_params = init_params.at[:, 0].set(
                phi0.astype(init_params.dtype))
            init_params = init_params.at[:, 1].set(
                dm0.astype(init_params.dtype))
        elif seed_phase:
            Grp, Gip, sd, gsr, gsi = setup_fn(data_ports, mrp, mip, w=w)
            init_params = init_params.at[:, 0].set(
                _brute_phase_seed(gsr, gsi, kvec).astype(
                    init_params.dtype))
        else:
            Grp, Gip, sd = setup_fn(data_ports, mrp, mip)
        S0 = jnp.sum(M2, axis=-1)
        Sd = jnp.sum(w * sd, axis=-1)
        if stats_dtype is not None:
            sdt = jnp.dtype(stats_dtype)
            Grp = Grp.astype(sdt)
            Gip = Gip.astype(sdt)
            M2 = M2.astype(sdt)
        setup_b = stats.FitSetup(
            Gr=Grp, Gi=Gip, M2=M2, w=w, freqs=freqs.astype(dt),
            P=Ps.astype(dt), nu_DM=nu_fits[:, 0].astype(dt),
            nu_GM=nu_fits[:, 1].astype(dt),
            nu_tau=nu_fits[:, 2].astype(dt), Sd=Sd.astype(dt), S0=S0,
            nbin=int(nbin), kvec=kvec,
            sd_chan=(w * sd).astype(dt))
        axes = stats.FitSetup(
            Gr=0, Gi=0, M2=None, w=0, freqs=0, P=0, nu_DM=0, nu_GM=0,
            nu_tau=0, Sd=0, S0=None, nbin=None, kvec=None, sd_chan=0)
        return jax.vmap(_fit_one, in_axes=(axes, 0))(setup_b, init_params)

    if seed_phase:
        # brute phase from the channel-mean profile cross-spectrum
        # (the pipeline's seeding, fused into this program)
        from pulseportraiture_tpu.ops.fourier import rfft_ri
        mp = data_ports.mean(axis=1)
        mm = jnp.broadcast_to(model_ports.mean(axis=-2), mp.shape)
        dr, di = rfft_ri(mp)
        smr, smi = rfft_ri(mm)
        gsr = dr * smr + di * smi
        gsi = di * smr - dr * smi
        kv = jnp.arange(gsr.shape[-1], dtype=gsr.dtype)
        init_params = init_params.at[:, 0].set(
            _brute_phase_seed(gsr, gsi, kv).astype(init_params.dtype))

    def one(data, model, x0, P, fr, er, wt, nf):
        setup = stats.make_setup(data, model, er, P, fr, nf[0], nf[1], nf[2],
                                 weights=wt, model_ft_ri=shared_mft,
                                 stats_dtype=stats_dtype)
        return _fit_one(setup, x0)

    if shared_mft is not None:
        return jax.vmap(
            lambda d, x0, P, fr, er, wt, nf:
                one(d, None, x0, P, fr, er, wt, nf))(
            data_ports, init_params, Ps, freqs, errs, weights, nu_fits)
    return jax.vmap(one)(data_ports, model_ports, init_params, Ps, freqs,
                         errs, weights, nu_fits)


# PortraitFitResult leaf widths for pack/unpack; nchan-sized fields are
# marked None.  Field order == NamedTuple order == tree_leaves order
# (channel_red_chi2 is always a concrete leaf in batched results).
_PACK_SIZES = (5, 5, None, None, 1, 1, 1, 25, 1, 1, 1, None, 1, 1, 1,
               None)
_PACK_INT = {12, 13, 14}            # niter, nfeval, return_code


def pack_result(res):
    """Flatten a batched PortraitFitResult into ONE (B, K) array.

    Every device->host transfer pays a latency per *array*, so fetching
    the 16-leaf result pytree costs 16 latencies per chunk; the packed
    form costs one.  Packs in the fit dtype (f32 device fits, f64 on x64
    CPU runs) so no precision is lost vs the pytree fetch; the int
    fields (niter/nfeval/return_code) are small counts, exact either
    way.  Inverse: unpack_result."""
    B = res.params.shape[0]
    dt = res.params.dtype
    return jnp.concatenate(
        [jnp.reshape(leaf, (B, -1)).astype(dt)
         for leaf in jax.tree_util.tree_leaves(res)], axis=1)


def unpack_result(arr, nchan):
    """Rebuild a host-side PortraitFitResult (numpy leaves, batch
    leading) from pack_result's (B, K) array."""
    import numpy as np
    arr = np.asarray(arr)
    B = arr.shape[0]
    leaves, off = [], 0
    for i, sz in enumerate(_PACK_SIZES):
        n = nchan if sz is None else sz
        leaf = arr[:, off:off + n]
        off += n
        if n == 1:
            leaf = leaf[:, 0]
        elif sz == 25:
            leaf = leaf.reshape(B, 5, 5)
        if i in _PACK_INT:
            leaf = leaf.astype(np.int32)
        leaves.append(leaf)
    assert off == arr.shape[1], (off, arr.shape)
    return PortraitFitResult(*leaves)


@functools.partial(jax.jit,
                   static_argnames=("fit_flags", "log10_tau", "max_iter",
                                    "scattering", "dft_precision",
                                    "stats_dtype", "ct", "seed_phase",
                                    "seed_dm", "mharm"))
def fit_portrait_full_batch_packed(*args, **kwargs):
    """fit_portrait_full_batch with the result packed into one (B, K)
    array (see pack_result) — a single device->host transfer per chunk
    instead of 16.  Same arguments; unpack with unpack_result."""
    return pack_result(fit_portrait_full_batch(*args, **kwargs))


def _make_fit_one(fit_flags, log10_tau, max_iter, scattering):
    """Optimize -> nu_zeros -> re-reference -> covariance for ONE item
    given a prebuilt FitSetup (all arguments static; vmap for batches)."""

    def _fit_one(setup, x0):
        res = newton.trust_region_minimize(
            lambda x: stats.chi2_value_grad_hess(x, setup,
                                                 fit_flags=fit_flags,
                                                 log10_tau=log10_tau,
                                                 scattering=scattering,
                                                 return_moments=True),
            x0, max_iter=max_iter, gtol=1e-11, xtol=1e-14, has_aux=True,
            step_mask=fit_flags)
        nzs = _nu_zeros_closed_form(res.x, setup, fit_flags, log10_tau,
                                    scattering=scattering, moments=res.aux)
        nu_out_DM, nu_out_GM, nu_out_tau = nzs
        if fit_flags[1]:
            nu_out_GM = nu_out_DM
        elif fit_flags[2]:
            nu_out_DM = nu_out_GM
        params_out = _rereference(res.x, setup, nu_out_DM, nu_out_GM,
                                  nu_out_tau, log10_tau)
        setup_out = setup._replace(nu_DM=nu_out_DM, nu_GM=nu_out_GM,
                                   nu_tau=nu_out_tau)
        outs = _finalize(params_out, setup_out, fit_flags, log10_tau,
                         res.fun, scattering=scattering, moments=res.aux)
        (cov, perrs, scales, scale_errs, channel_snrs, snr, chi2,
         red_chi2, ch_rchi2) = outs
        return PortraitFitResult(
            params=params_out, param_errs=perrs, scales=scales,
            scale_errs=scale_errs, nu_DM=nu_out_DM, nu_GM=nu_out_GM,
            nu_tau=nu_out_tau, covariance_matrix=cov, chi2=chi2,
            red_chi2=red_chi2, snr=snr, channel_snrs=channel_snrs,
            niter=res.niter, nfeval=res.nfev, return_code=res.status,
            channel_red_chi2=ch_rchi2)

    return _fit_one


def fit_batch_from_setup(setup_b, init_params, setup_axes=None,
                         fit_flags=(1, 1, 0, 0, 0), log10_tau=True,
                         max_iter=100, scattering=None):
    """Batched fit over a prebuilt (leading-axis) FitSetup pytree.

    setup_axes: a FitSetup of vmap in_axes (0 for per-item fields, None
    for shared fields like M2/S0/kvec); defaults to all-0 with nbin and
    kvec shared.  The multi-chip route builds the setup per shard under
    shard_map and lets GSPMD partition this Newton loop
    (parallel/mesh.py).
    """
    if fit_flags[3] or fit_flags[4]:
        scattering = True
    elif scattering is None:
        scattering = True
    if setup_axes is None:
        setup_axes = stats.FitSetup(
            Gr=0, Gi=0, M2=0, w=0, freqs=0, P=0, nu_DM=0, nu_GM=0,
            nu_tau=0, Sd=0, S0=0, nbin=None, kvec=None, sd_chan=0)
    fit_one = _make_fit_one(tuple(int(bool(f)) for f in fit_flags),
                            log10_tau, max_iter, scattering)
    return jax.vmap(fit_one, in_axes=(setup_axes, 0))(setup_b, init_params)


def _nu_zeros_closed_form(params, setup, fit_flags, log10_tau,
                          scattering=True, moments=None):
    """In-jit zero-covariance frequencies for closed-form flag combos.

    Falls back to the fit references for polynomial (GM) branches.
    """
    ff = tuple(int(bool(f)) for f in fit_flags)
    if ff in ((1, 1, 0, 0, 0), (1, 0, 1, 0, 0), (0, 0, 0, 1, 1),
              (1, 1, 0, 1, 0), (1, 1, 0, 1, 1), (1, 1, 1, 1, 1),
              (1, 1, 1, 0, 0), (1, 1, 1, 1, 0)):
        # the GM polynomial branches pick their root on device via the
        # scaled-Horner grid + masked-bisection solver
        # (fitters/nu_zeros.py:_nearest_positive_real_root) — fully
        # batchable under vmap, no host callbacks
        nz = nu_zeros.get_nu_zeros(params, setup, fit_flags=ff,
                                   log10_tau=log10_tau,
                                   scattering=scattering, moments=moments)
        return nz[0], nz[1], nz[2]
    return setup.nu_DM, setup.nu_GM, setup.nu_tau
