"""Evolving Gaussian-component portrait models and their fitters.

Parameter layout matches the reference's .gmodel convention
(pplib.py:853-930): params = [dc, tau_bin, (loc, m_loc, wid, m_wid, amp,
m_amp) * ngauss (+ 2*njoin join params)], with per-channel evolution of
(loc, wid, amp) controlled by a three-digit model code ('0' power-law,
'1' linear).

The portrait generator is fully vectorized over channels (the reference
loops per channel, pplib.py:911-914) and differentiable, so the lmfit
Levenberg-Marquardt fits (pplib.py:1842-2052) are replaced by a
jit-compiled LM with exact JAX Jacobians and lmfit/MINUIT-style bound
transforms.
"""

from __future__ import annotations

import functools

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pulseportraiture_tpu.config import WID_MAX
from pulseportraiture_tpu.ops.scattering import (scattering_portrait_FT_ri,
                                                 scattering_profile_FT_ri,
                                                 scattering_times)
from pulseportraiture_tpu.utils import DataBunch

_FWHM = 2.0 * jnp.sqrt(2.0 * jnp.log(2.0))


def power_law_evolution(freqs, nu_ref, parameter, index):
    """F(nu) = parameter * (nu/nu_ref)**index.  Reference: pplib.py:996-1011."""
    freqs = jnp.asarray(freqs)
    parameter = jnp.atleast_1d(jnp.asarray(parameter))
    index = jnp.atleast_1d(jnp.asarray(index))
    log_ratio = jnp.log(freqs) - jnp.log(nu_ref)
    return jnp.exp(jnp.outer(log_ratio, index) +
                   jnp.log(parameter)[None, :])


def linear_evolution(freqs, nu_ref, parameter, slope):
    """F(nu) = parameter + slope*(nu - nu_ref).  Reference: pplib.py:1013-1028."""
    freqs = jnp.asarray(freqs)
    parameter = jnp.atleast_1d(jnp.asarray(parameter))
    slope = jnp.atleast_1d(jnp.asarray(slope))
    return jnp.outer(freqs - nu_ref, slope) + parameter[None, :]


_EVOLUTION_FUNCTIONS = {"0": power_law_evolution, "1": linear_evolution}


def evolve_parameter(freqs, nu_ref, parameter, evol_parameter, code):
    """Dispatch on single-digit evolution code.  Reference: pplib.py:1030-1046."""
    return _EVOLUTION_FUNCTIONS[code](freqs, nu_ref, parameter,
                                      evol_parameter)


def _gaussian_profiles_vec(nbin, locs, wids, amps):
    """Peak-normalized Gaussians for stacked (..., ngauss) parameters.

    Vectorized equivalent of the reference's per-channel gaussian_profile
    calls (pplib.py:770-825), matching its wraparound, |z|<20 cutoff, and
    nearest-bin-center peak normalization.
    """
    dtype = jnp.result_type(locs, wids, amps, float)
    locval = (jnp.arange(nbin, dtype=dtype) + 0.5) / nbin  # (nbin,)
    mean = locs[..., None] % 1.0                           # (..., ngauss, 1)
    lv = jnp.broadcast_to(locval, mean.shape[:-1] + (nbin,))
    lv = jnp.where(mean < 0.5,
                   jnp.where(lv > mean + 0.5, lv - 1.0, lv),
                   jnp.where(lv < mean - 0.5, lv + 1.0, lv))
    safe_wid = jnp.where(wids > 0.0, wids, 1.0)
    sigma = (safe_wid / _FWHM)[..., None]
    zs = (lv - mean) / sigma
    vals = jnp.where(jnp.abs(zs) < 20.0, jnp.exp(-0.5 * zs ** 2), 0.0)
    # nearest-bin-center renormalization: divide by max val, multiply by
    # exp(-z_peak^2/2) with z_peak from the true loc
    peak = jnp.max(vals, axis=-1, keepdims=True)
    imax = jnp.argmax(vals, axis=-1, keepdims=True)
    lv_peak = jnp.take_along_axis(lv, imax, axis=-1)
    z_peak = (lv_peak - locs[..., None]) / sigma
    fact = jnp.where(peak > 0.0,
                     jnp.exp(-0.5 * z_peak ** 2) /
                     jnp.where(peak > 0.0, peak, 1.0), 0.0)
    vals = vals * fact
    vals = jnp.where((wids > 0.0)[..., None], vals, 0.0)
    return jnp.sum(vals * amps[..., None], axis=-2)  # sum over ngauss


def gen_gaussian_profile(params, nbin):
    """DC + ngauss Gaussians (+ scattering convolution via analytic FT).

    params = [dc, tau_bin, (loc, wid, amp) * ngauss].
    Reference: pplib.py:827-851.
    """
    params = jnp.asarray(params)
    ngauss = (params.shape[0] - 2) // 3
    locs = params[2::3][:ngauss]
    wids = params[3::3][:ngauss]
    amps = params[4::3][:ngauss]
    model = params[0] + _gaussian_profiles_vec(nbin, locs, wids, amps)
    tau_bin = params[1]
    # split-real scattering convolution
    from pulseportraiture_tpu.ops.fourier import irfft_ri, rfft_ri
    Br, Bi = scattering_profile_FT_ri(tau_bin / nbin, nbin,
                                      dtype=model.dtype)
    re, im = rfft_ri(model[None, :])
    scattered = irfft_ri(re * Br - im * Bi, re * Bi + im * Br, n=nbin)[0]
    return jnp.where(tau_bin != 0.0, scattered, model)


def gen_gaussian_portrait(model_code, params, scattering_index, phases,
                          freqs, nu_ref, join_ichans=(), P=None):
    """Evolving Gaussian-component model portrait (nchan, nbin).

    Reference: pplib.py:853-930.  Vectorized over channels; scattering is
    applied portrait-wide via the analytic FT; optional join rotations are
    applied to listed channel groups.
    """
    params = jnp.asarray(params)
    freqs = jnp.asarray(freqs)
    nbin = len(phases)
    njoin = len(join_ichans)
    if njoin:
        join_params = params[-njoin * 2:]
        params = params[:-njoin * 2]
    dc = params[0]
    tau = params[1]
    refparams = params[2::2]        # (loc, wid, amp) per gauss at nu_ref
    evolparams = params[3::2]       # (m_loc, m_wid, m_amp) per gauss
    locs0, wids0, amps0 = refparams[0::3], refparams[1::3], refparams[2::3]
    m_locs, m_wids, m_amps = evolparams[0::3], evolparams[1::3], \
        evolparams[2::3]
    locs = evolve_parameter(freqs, nu_ref, locs0, m_locs, model_code[0])
    wids = evolve_parameter(freqs, nu_ref, wids0, m_wids, model_code[1])
    amps = evolve_parameter(freqs, nu_ref, amps0, m_amps, model_code[2])
    gport = dc + _gaussian_profiles_vec(nbin, locs, wids, amps)
    # portrait-wide scattering (tau in [bin] at nu_ref, pplib.py:915-922)
    # split-real convolution
    from pulseportraiture_tpu.ops.fourier import irfft_ri, rfft_ri
    taus = scattering_times(tau / nbin, scattering_index, freqs, nu_ref)
    Br, Bi = scattering_portrait_FT_ri(taus.astype(gport.dtype), nbin)
    re, im = rfft_ri(gport)
    scattered = irfft_ri(re * Br - im * Bi, re * Bi + im * Br, n=nbin)
    gport = jnp.where(tau != 0.0, scattered, gport)
    if njoin:
        from pulseportraiture_tpu.ops.rotate import rotate_data
        gport_np = gport
        for ij in range(njoin):
            ichans = jnp.asarray(join_ichans[ij])
            phi_j = join_params[0::2][ij]
            DM_j = join_params[1::2][ij]
            rotated = rotate_data(gport_np[ichans], phi_j, DM_j, P,
                                  freqs[ichans], nu_ref)
            gport_np = gport_np.at[ichans].set(rotated)
        gport = gport_np
    return gport


#: jitted portrait generator for host callers that evaluate the model
#: eagerly between fit iterations (portrait.py make_gaussian_model) —
#: one compiled program instead of a dispatch per eager primitive.
gen_gaussian_portrait_jit = jax.jit(
    gen_gaussian_portrait, static_argnames=("model_code", "join_ichans"))


# ----------------------------------------------------------------------
# Bounded Levenberg-Marquardt (replaces lmfit; pplib.py:1842-2052)
# ----------------------------------------------------------------------

class LMResult(NamedTuple):
    x: jnp.ndarray
    chi2: jnp.ndarray
    niter: jnp.ndarray
    converged: jnp.ndarray


def _to_internal(x, lo, hi):
    """lmfit/MINUIT bound transform: external -> internal (free) variable."""
    both = jnp.isfinite(lo) & jnp.isfinite(hi)
    lo_only = jnp.isfinite(lo) & ~jnp.isfinite(hi)
    hi_only = ~jnp.isfinite(lo) & jnp.isfinite(hi)
    x_c = jnp.clip(x, lo + 1e-300, hi - 1e-300)
    arg = 2.0 * (x_c - lo) / jnp.where(both, hi - lo, 1.0) - 1.0
    i_both = jnp.arcsin(jnp.clip(arg, -1.0, 1.0))
    i_lo = jnp.sqrt(jnp.maximum((x - lo + 1.0) ** 2 - 1.0, 0.0))
    i_hi = jnp.sqrt(jnp.maximum((hi - x + 1.0) ** 2 - 1.0, 0.0))
    return jnp.where(both, i_both, jnp.where(lo_only, i_lo,
                                             jnp.where(hi_only, i_hi, x)))


def _to_external(u, lo, hi):
    both = jnp.isfinite(lo) & jnp.isfinite(hi)
    lo_only = jnp.isfinite(lo) & ~jnp.isfinite(hi)
    hi_only = ~jnp.isfinite(lo) & jnp.isfinite(hi)
    e_both = lo + (jnp.sin(u) + 1.0) * jnp.where(both, hi - lo, 1.0) / 2.0
    e_lo = lo - 1.0 + jnp.sqrt(u ** 2 + 1.0)
    e_hi = hi + 1.0 - jnp.sqrt(u ** 2 + 1.0)
    return jnp.where(both, e_both, jnp.where(lo_only, e_lo,
                                             jnp.where(hi_only, e_hi, u)))


def _lm_core(residual_fn, x0, lo, hi, mask, max_iter, ftol, xtol):
    """Bounded LM loop body (pure; trace under jit or run eagerly).

    Returns (x_ext, chi2, niter, converged)."""

    def ext(u):
        xe = _to_external(u, lo, hi)
        return jnp.where(mask > 0, xe, x0)

    def r_of(u):
        return residual_fn(ext(u))

    u0 = _to_internal(x0, lo, hi)
    r0 = r_of(u0)
    J_fn = jax.jacfwd(r_of)

    def cond(state):
        u, lam, chi2, it, done = state
        return (~done) & (it < max_iter)

    def body(state):
        u, lam, chi2, it, _ = state
        r = r_of(u)
        J = J_fn(u)  # (m, p)
        JtJ = jnp.matmul(J.T, J, precision=jax.lax.Precision.HIGHEST)
        Jtr = jnp.matmul(J.T, r, precision=jax.lax.Precision.HIGHEST)
        # mask frozen parameters: identity rows to keep the solve regular
        JtJ = JtJ * jnp.outer(mask, mask) + jnp.diag(1.0 - mask)
        Jtr = Jtr * mask
        diag = jnp.clip(jnp.diag(JtJ), 1e-30)
        step = jnp.linalg.solve(JtJ + lam * jnp.diag(diag), -Jtr)
        u_new = u + step
        r_new = r_of(u_new)
        chi2_new = jnp.sum(r_new ** 2)
        improved = (chi2_new < chi2) & jnp.isfinite(chi2_new)
        u = jnp.where(improved, u_new, u)
        lam = jnp.where(improved, jnp.maximum(lam / 10.0, 1e-14),
                        jnp.minimum(lam * 10.0, 1e14))
        rel_df = (chi2 - chi2_new) / jnp.maximum(chi2, 1e-300)
        done = improved & ((rel_df < ftol) |
                           (jnp.max(jnp.abs(step)) < xtol))
        chi2 = jnp.where(improved, chi2_new, chi2)
        return (u, lam, chi2, it + 1, done)

    chi2_0 = jnp.sum(r0 ** 2)
    state = (u0, jnp.asarray(1e-3, x0.dtype), chi2_0, jnp.asarray(0),
             jnp.asarray(False))
    u, lam, chi2, it, done = jax.lax.while_loop(cond, body, state)
    return ext(u), chi2, it, done


def levenberg_marquardt(residual_fn, x0, lo, hi, fit_mask, max_iter=200,
                        ftol=1e-12, xtol=1e-12):
    """Bounded LM minimization of sum(residual_fn(x)**2).

    residual_fn: x (p,) -> residuals (m,).  Bounds handled by smooth
    transforms; frozen parameters (fit_mask=0) are held at x0.  The
    Jacobian is exact (jax.jacfwd of the transformed residual).

    NOTE: this eager entry point closes over the residual's data, so
    the loop recompiles per call with the data baked in as HLO
    constants.  Hot model-build callers use levenberg_marquardt_jit
    with the data threaded as traced args; this stays for small/
    one-off fits (fitters/powlaw.py).
    """
    x0 = jnp.asarray(x0)
    lo = jnp.asarray(lo)
    hi = jnp.asarray(hi)
    mask = jnp.asarray(fit_mask, dtype=x0.dtype)
    x, chi2, it, done = _lm_core(residual_fn, x0, lo, hi, mask,
                                 max_iter, ftol, xtol)
    return LMResult(x=x, chi2=chi2, niter=it, converged=done)


@functools.lru_cache(maxsize=64)
def _lm_jit_cache(residual_fn, max_iter, ftol, xtol):
    """Jitted LM driver for a MODULE-LEVEL residual_fn(x, *res_args).

    One compiled program covers the preamble, the whole while_loop,
    and the masked JtJ curvature at the solution.  The residual's data
    arrives as traced arguments, so the executable caches on shapes —
    a per-call closure would bake each archive's portrait into the HLO
    as constants and recompile the loop every call, which dominated
    ppgauss builds."""

    @jax.jit
    def run(x0, lo, hi, mask, *res_args):
        def rf(x):
            return residual_fn(x, *res_args)

        x, chi2, it, done = _lm_core(rf, x0, lo, hi, mask, max_iter,
                                     ftol, xtol)
        J = jax.jacfwd(rf)(x)
        J = jnp.where(jnp.isfinite(J), J, 0.0)
        return x, chi2, it, done, jnp.matmul(
            J.T, J, precision=jax.lax.Precision.HIGHEST)

    return run


def levenberg_marquardt_jit(residual_fn, x0, lo, hi, fit_mask,
                            res_args=(), max_iter=200, ftol=1e-12,
                            xtol=1e-12):
    """Fully-jitted bounded LM + solution curvature.

    residual_fn must be a MODULE-LEVEL (or lru-cached) function with
    signature residual_fn(x, *res_args) so the jit cache hits across
    calls; res_args are traced.  Returns (LMResult, JtJ) with JtJ the
    (p, p) masked-jacobian Gram matrix at the solution (host errors
    via _param_errs_from_jtj)."""
    x0 = jnp.asarray(x0)
    run = _lm_jit_cache(residual_fn, int(max_iter), float(ftol),
                        float(xtol))
    x, chi2, it, done, JtJ = run(
        x0, jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(fit_mask, dtype=x0.dtype), *res_args)
    return LMResult(x=x, chi2=chi2, niter=it, converged=done), JtJ


def _profile_bounds(nparam, wid_max=WID_MAX):
    """Bounds for [dc, tau, (loc, wid, amp)*n]: tau>=0, 0<=wid<=wid_max,
    amp>=0 (reference pplib.py:1874-1894)."""
    lo = np.full(nparam, -np.inf)
    hi = np.full(nparam, np.inf)
    lo[1] = 0.0
    for i in range(2, nparam, 3):
        lo[i + 1] = 0.0
        hi[i + 1] = wid_max
        lo[i + 2] = 0.0
    return jnp.asarray(lo), jnp.asarray(hi)


def fit_gaussian_profile(data, init_params, errs, fit_flags=None,
                         fit_scattering=False, quiet=True):
    """Fit DC + ngauss Gaussians (+ scattering) to a profile.

    Reference: pplib.py:1842-1922.
    """
    data = jnp.asarray(data)
    init_params = jnp.asarray(init_params, dtype=data.dtype)
    nparam = init_params.shape[0]
    nbin = data.shape[0]
    if fit_flags is None:
        mask = np.ones(nparam)
        mask[1] = 1.0 if fit_scattering else 0.0
    else:
        mask = np.array([float(bool(fit_flags[0])),
                         1.0 if fit_scattering else 0.0] +
                        [float(bool(f)) for f in fit_flags[1:nparam - 1]])
    lo, hi = _profile_bounds(nparam)
    err_arr = jnp.broadcast_to(jnp.asarray(errs), data.shape)

    res, JtJ = levenberg_marquardt_jit(_profile_residual, init_params,
                                       lo, hi, jnp.asarray(mask),
                                       res_args=(data, err_arr))
    dof = nbin - int(mask.sum())
    residuals = np.asarray(
        _profile_residual(res.x, data, err_arr)) * np.asarray(err_arr)
    fit_errs = _param_errs_from_jtj(np.asarray(JtJ, np.float64), mask)
    return DataBunch(fitted_params=np.asarray(res.x), fit_errs=fit_errs,
                     residuals=residuals, chi2=float(res.chi2), dof=dof,
                     red_chi2=float(res.chi2) / max(dof, 1),
                     niter=int(res.niter))


def _profile_residual(p, data, err_arr):
    """Module-level profile-fit residual (levenberg_marquardt_jit)."""
    return (data - gen_gaussian_profile(p, data.shape[0])) / err_arr


@functools.lru_cache(maxsize=32)
def _portrait_residual_fn(model_code, join_ichans_static, with_P):
    """Module-level (lru-cached) portrait-fit residual for
    levenberg_marquardt_jit: statics ride the cache key, the data/
    phases/freqs arrive as traced args so the compiled LM program is
    reused across archives."""

    def residual(p, data, err_arr, phases, freqs, nu_ref, *rest):
        model = gen_gaussian_portrait(
            model_code, p[:-1], p[-1], phases, freqs, nu_ref,
            join_ichans=join_ichans_static,
            P=rest[0] if with_P else None)
        return ((data - model) / err_arr).ravel()

    return residual


def _param_errs_from_jtj(JtJ, mask):
    """1-sigma errors from the (p, p) JtJ curvature at the solution.

    Only the tiny curvature matrix crosses to the host — at
    4096ch x 2048bin the Jacobian itself is ~0.7 GB."""
    m = np.asarray(mask) > 0
    JtJ = np.asarray(JtJ, dtype=np.float64)
    errs = np.zeros(JtJ.shape[0])
    sub = JtJ[np.ix_(m, m)]
    # pinv: singular directions (e.g. tau pinned at its 0 bound) get zero
    # error instead of poisoning every other parameter's error
    try:
        cov = np.linalg.pinv(sub)
        diag = np.diag(cov)
    except np.linalg.LinAlgError:
        # LAPACK SVD can fail to converge on ill-conditioned curvature
        # (seen on large-nchan Gaussian-portrait fits); fall back to the
        # uncorrelated diagonal approximation, as the reference's lmfit
        # does when its covariance estimate is unavailable
        d = np.diag(sub)
        diag = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    errs[m] = np.sqrt(np.clip(diag, 0.0, None))
    return errs


def fit_gaussian_portrait(model_code, data, init_params, scattering_index,
                          errs, fit_flags, fit_scattering_index, phases,
                          freqs, nu_ref, join_params=(), P=None, quiet=True):
    """Fit evolving Gaussian components to a portrait.

    Parameters follow the reference (pplib.py:1924-2052): init_params =
    [dc, tau, (loc, m_loc, wid, m_wid, amp, m_amp)*ngauss]; the scattering
    index is appended internally as the last fit parameter.
    """
    data = jnp.asarray(data)
    init_params = jnp.asarray(init_params, dtype=data.dtype)
    nparam = init_params.shape[0]
    nbin = data.shape[-1]
    freqs = jnp.asarray(freqs)
    # bounds: dc free; tau >= 0; wid in [0, wid_max]; amp >= 0; evolution
    # parameters free (reference pplib.py:1964-1988)
    lo = np.full(nparam + 1, -np.inf)
    hi = np.full(nparam + 1, np.inf)
    lo[1] = 0.0
    for i in range(2, nparam, 6):
        lo[i + 2] = 0.0
        hi[i + 2] = WID_MAX
        lo[i + 4] = 0.0
    mask = np.array([float(bool(f)) for f in fit_flags] +
                    [1.0 if fit_scattering_index else 0.0])

    if len(join_params):
        join_ichans = join_params[0]
        join_vals = np.asarray(join_params[1], dtype=float)
        join_mask = np.asarray([float(bool(f)) for f in join_params[2]])
        # join params ride between the model params and scattering index
        init_full = jnp.concatenate([
            init_params, jnp.asarray(join_vals, dtype=data.dtype),
            jnp.asarray([scattering_index], dtype=data.dtype)])
        lo = np.concatenate([lo[:-1], np.full(len(join_vals), -np.inf),
                             [-np.inf]])
        hi = np.concatenate([hi[:-1], np.full(len(join_vals), np.inf),
                             [np.inf]])
        mask = np.concatenate([mask[:-1], join_mask,
                               [1.0 if fit_scattering_index else 0.0]])
    else:
        join_ichans = []
        init_full = jnp.concatenate([
            init_params, jnp.asarray([scattering_index], dtype=data.dtype)])

    err_arr = jnp.broadcast_to(jnp.asarray(errs)[..., None], data.shape)
    join_ichans_static = tuple(tuple(np.asarray(ic).tolist())
                               for ic in join_ichans)

    residual = _portrait_residual_fn(str(model_code), join_ichans_static,
                                     P is not None)
    res_args = [data, err_arr, jnp.asarray(phases),
                freqs, jnp.asarray(nu_ref, data.dtype)]
    if P is not None:
        res_args.append(jnp.asarray(P, data.dtype))
    res, JtJ = levenberg_marquardt_jit(residual, init_full,
                                       jnp.asarray(lo), jnp.asarray(hi),
                                       jnp.asarray(mask),
                                       res_args=tuple(res_args))
    dof = data.size - int(mask.sum())
    x = np.asarray(res.x)
    fit_errs_all = _param_errs_from_jtj(np.asarray(JtJ, np.float64), mask)
    return DataBunch(fitted_params=x[:-1], fit_errs=fit_errs_all[:-1],
                     scattering_index=float(x[-1]),
                     scattering_index_err=float(fit_errs_all[-1]),
                     chi2=float(res.chi2), dof=dof,
                     red_chi2=float(res.chi2) / max(dof, 1),
                     niter=int(res.niter))
