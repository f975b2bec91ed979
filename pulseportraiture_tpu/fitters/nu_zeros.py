"""Zero-covariance reference frequencies for the wideband fit.

After the fit, phase is re-referenced to the frequency at which its
covariance with DM (or GM, or tau) vanishes, computed in closed form from
the per-channel Hessian.  All branch formulas follow the reference
(pptoaslib.py:733-906) exactly:

  [1,1,0,0,0]  phi+DM:        weighted harmonic mean (closed form, JAX)
  [1,0,1,0,0]  phi+GM:        nu^-4 analogue (closed form, JAX)
  [0,0,0,1,1]  tau+alpha:     log-space mean (closed form, JAX)
  [1,1,0,1,0]  phi+DM+tau:    3x3 cofactor closed form (JAX)
  [1,1,1,0,0]  phi+DM+GM:     even degree-6 polynomial -> cubic in nu^2
                              (device grid+bisection root solver)
  [1,1,0,1,1]  phi+DM+tau+a:  4x4 cofactor closed form (JAX)
  [1,1,1,1,0]  no alpha:      degree-5/4 polynomial in nu^2 (device
                              grid+bisection root solver)
  [1,1,1,1,1]  all:           approximated by the [1,1,0,1,1] formulas

Where the reference divides per-channel Hessian entries by the phase/DM
derivative or log-frequency ratio (pptoaslib.py:748, 756, 765, ...), we
use the exact algebraic identities instead: DM/GM dependence enters only
linearly through phi_n, so Hn[1,j] = phis_d[1] * Hn[0,j] and
Hn[2,j] = phis_d[2] * Hn[0,j] per channel; likewise the alpha row is
Hn[4,j] = (dtau_a/dtau_t) * Hn[3,j] with dtau_a = ln(nu/nu_tau) * taus.
The quotients are therefore division-free — the reference's forms give
0/0 = NaN whenever a channel frequency equals the fit reference (e.g.
evenly spaced odd-nchan grids, where mean(freqs) IS the center channel).

Polynomial branches solve their root pick entirely on device with the
scaled-Horner grid + masked-bisection solver at the bottom of this file
(no nonsymmetric eigensolve, np.roots or host callback), so GM fits
batch under vmap/jit.
Limitations vs the reference's np.roots (documented in PARITY.md): only
roots bracketed by a sign change on the 1e-3..1e3 x target log grid are
found — even-multiplicity (double) roots and roots outside that window
fall back to the fit reference frequency.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from pulseportraiture_tpu.config import DCONST
from pulseportraiture_tpu.fitters import stats


def get_nu_zeros(params, setup, fit_flags=(1, 1, 1, 1, 1), log10_tau=True,
                 option=0, scattering=True, moments=None):
    """Return [nu_zero_DM, nu_zero_GM, nu_zero_tau].

    Closed-form branches stay on device; polynomial branches transfer the
    (5,5,nchan) per-channel Hessian to host (runs once per fit).
    scattering=False is the same static specialization as in stats._moments
    (skips the 9-reduction scattering pass when tau is identically zero).
    moments: optional precomputed reductions dict at (params, setup) — the
    optimizer's final evaluation — avoiding another pass over the spectra.
    """
    ff = tuple(int(bool(f)) for f in fit_flags)
    if moments is not None:
        Hn = stats.hess_per_channel_from_moments(
            moments, setup, fit_flags=(1, 1, 1, 1, 1))
    else:
        Hn = stats.chi2_hess_per_channel(params, setup,
                                         fit_flags=(1, 1, 1, 1, 1),
                                         log10_tau=log10_tau,
                                         scattering=scattering)
    freqs = setup.freqs
    taus, dtau, _ = stats._taus_and_derivs(params, setup, log10_tau)
    nu_DM, nu_GM, nu_tau = setup.nu_DM, setup.nu_GM, setup.nu_tau

    # Hn[3,j]/ln(nu/nu_tau) == (taus/dtau_t) * Hn[3,j] with the alpha row
    # substituted (identity above); guard dtau_t = 0 (tau == 0 exactly).
    tau_row_fact = jnp.where(dtau[0] != 0.0,
                             taus / jnp.where(dtau[0] != 0.0, dtau[0], 1.0),
                             0.0)

    if ff == (1, 1, 0, 0, 0):  # pptoaslib.py:746-752
        H21_n = Hn[0, 0]  # == Hn[0,1]/phis_d[1], division-free
        nu_zero_DM = (jnp.sum(freqs ** -2 * H21_n) / jnp.sum(H21_n)) ** -0.5
        return [nu_zero_DM, nu_GM, nu_tau]

    if ff == (1, 0, 1, 0, 0):  # pptoaslib.py:753-760
        H21_n = Hn[0, 0]  # == Hn[0,2]/phis_d[2]
        nu_zero_GM = (jnp.sum(freqs ** -4 * H21_n) / jnp.sum(H21_n)) ** -0.25
        return [nu_DM, nu_zero_GM, nu_tau]

    if ff == (0, 0, 0, 1, 1):  # pptoaslib.py:761-767
        H21_n = tau_row_fact * Hn[3, 3]  # == Hn[3,4]/log_ratio
        nu_zero_tau = jnp.exp(jnp.sum(jnp.log(freqs) * H21_n) /
                              jnp.sum(H21_n))
        return [nu_DM, nu_GM, nu_zero_tau]

    if ff == (1, 1, 0, 1, 0):  # pptoaslib.py:768-778
        # sub-Hessian over (phi, DM, tau)
        H21_n = Hn[0, 0]           # == Hn[1,0]/phis_d[1]
        H23_n = Hn[0, 3]           # == Hn[1,3]/phis_d[1]
        H13 = jnp.sum(Hn[3, 0])
        H33 = jnp.sum(Hn[3, 3])
        numer = H13 * jnp.sum(freqs ** -2 * H23_n) - \
            H33 * jnp.sum(freqs ** -2 * H21_n)
        denom = H13 * jnp.sum(H23_n) - H33 * jnp.sum(H21_n)
        nu_zero_DM = (numer / denom) ** -0.5
        return [nu_zero_DM, nu_GM, nu_tau]

    if ff == (1, 1, 0, 1, 1) or ff == (1, 1, 1, 1, 1):
        # pptoaslib.py:813-836; the all-fit case approximates with this
        # branch (pptoaslib.py:893-901).
        idx = [0, 1, 3, 4]  # drop GM
        H = Hn[jnp.array(idx)][:, jnp.array(idx)]  # (4,4,nchan)
        # rows divided by phis_d[1] -> phi row; alpha rows -> tau row scaled
        H21_n, H23_n, H24_n = H[0, 0], H[0, 2], H[0, 3]
        H41_n, H42_n, H43_n = (tau_row_fact * H[2, 0],
                               tau_row_fact * H[2, 1],
                               tau_row_fact * H[2, 2])
        Hij = jnp.sum(H, axis=-1)
        H11, H22, H33, H44 = Hij[0, 0], Hij[1, 1], Hij[2, 2], Hij[3, 3]
        H12, H13, H14 = Hij[0, 1], Hij[0, 2], Hij[0, 3]
        H23, H24 = Hij[1, 2], Hij[1, 3]
        H34 = Hij[2, 3]
        f2 = freqs ** -2
        numer = ((H34 * H34 - H33 * H44) * jnp.sum(f2 * H21_n) +
                 (H13 * H44 - H14 * H34) * jnp.sum(f2 * H23_n) +
                 (H14 * H33 - H13 * H34) * jnp.sum(f2 * H24_n))
        denom = ((H34 * H34 - H33 * H44) * jnp.sum(H21_n) +
                 (H13 * H44 - H14 * H34) * jnp.sum(H23_n) +
                 (H14 * H33 - H13 * H34) * jnp.sum(H24_n))
        nu_zero_DM = (numer / denom) ** -0.5
        lf = jnp.log(freqs)
        numer_t = ((H13 * H22 - H12 * H23) * jnp.sum(lf * H41_n) +
                   (H11 * H23 - H12 * H13) * jnp.sum(lf * H42_n) +
                   (H12 * H12 - H11 * H22) * jnp.sum(lf * H43_n))
        denom_t = ((H13 * H22 - H12 * H23) * jnp.sum(H41_n) +
                   (H11 * H23 - H12 * H13) * jnp.sum(H42_n) +
                   (H12 * H12 - H11 * H22) * jnp.sum(H43_n))
        nu_zero_tau = jnp.exp(numer_t / denom_t)
        return [nu_zero_DM, nu_GM, nu_zero_tau]

    if ff == (1, 1, 1, 0, 0):  # pptoaslib.py:779-812, polynomial
        # identity substitutions: the reference divides the DM/GM rows by
        # the FULL phis_deriv here, so Hn[1,j]/pd1 = Hn[2,j]/pd2 = Hn[0,j]
        # exactly (no leftover constants)
        if option == 0:  # zero covariance between phi and DM
            H21_n, H23_n = Hn[0, 0], Hn[0, 2]
            H31_n, H33_n = Hn[0, 0], Hn[0, 2]
            A, B = (H31_n * freqs ** -4).sum(), H31_n.sum()
            C, D = (H23_n * freqs ** -2).sum(), H23_n.sum()
            E, F = (H33_n * freqs ** -4).sum(), H33_n.sum()
            G, H = (H21_n * freqs ** -2).sum(), H21_n.sum()
        elif option == 1:  # zero covariance between phi and GM
            H21_n, H22_n = Hn[0, 0], Hn[0, 1]
            H31_n, H32_n = Hn[0, 0], Hn[0, 1]
            A, B = (H21_n * freqs ** -4).sum(), H21_n.sum()
            C, D = (H32_n * freqs ** -2).sum(), H32_n.sum()
            E, F = (H22_n * freqs ** -4).sum(), H22_n.sum()
            G, H = (H31_n * freqs ** -2).sum(), H31_n.sum()
        else:
            return [nu_DM, nu_GM, nu_tau]
        coeffs = jnp.stack([(A * C - E * G), jnp.zeros_like(A),
                            (E * H - A * D), jnp.zeros_like(A),
                            (F * G - B * C), jnp.zeros_like(A),
                            (B * D - F * H)])
        nu_zero = _nearest_positive_real_root(coeffs, freqs.mean(),
                                              square=False)
        return [nu_zero, nu_zero, nu_tau]

    if ff == (1, 1, 1, 1, 0):  # pptoaslib.py:837-892, polynomial
        P = setup.P
        Hij = Hn[:4, :4].sum(axis=-1)
        # the reference divides by bare (nu^-2 - nu_DM^-2) etc; the
        # identity rows carry the extra Dconst/P factors explicitly
        c1 = DCONST / P
        c2 = DCONST ** 2 / P
        H14, H44 = Hij[3, 0], Hij[3, 3]
        if option == 0:
            H21_n, H23_n, H24_n = (c1 * Hn[0, 0], c1 * Hn[0, 2],
                                   c1 * Hn[0, 3])
            H31_n, H33_n, H34_n = (c2 * Hn[0, 0], c2 * Hn[0, 2],
                                   c2 * Hn[0, 3])
            A, a = (freqs ** -4 * H34_n).sum(), H34_n.sum()
            B, b = (freqs ** -2 * H21_n).sum(), H21_n.sum()
            C, c = (freqs ** -4 * H31_n).sum(), H31_n.sum()
            D, d = (freqs ** -2 * H23_n).sum(), H23_n.sum()
            E, e = (freqs ** -4 * H33_n).sum(), H33_n.sum()
            F, f = (freqs ** -2 * H24_n).sum(), H24_n.sum()
            P5 = A * A * B + H44 * C * D + H14 * E * F - H44 * B * E - \
                A * C * F - H14 * A * D
            P4 = -A * A * b - H44 * C * d - H14 * E * f + H44 * b * E + \
                A * C * f + H14 * A * d
            P3 = -2 * A * a * B - H44 * c * D - H14 * e * F + H44 * B * e + \
                (A * c + a * C) * F + H14 * a * D
            P2 = 2 * A * a * b + H44 * c * d + H14 * e * f - H44 * b * e - \
                (A * c + a * C) * f - H14 * a * d
            P1 = a * a * B - a * c * F
            P0 = -a * a * b + a * c * f
            coeffs = jnp.stack([P5, P4, P3, P2, P1, P0])
        elif option == 1:
            H21_n, H22_n, H24_n = (c1 * Hn[0, 0], c1 * Hn[0, 1],
                                   c1 * Hn[0, 3])
            H31_n, H32_n, H34_n = (c2 * Hn[0, 0], c2 * Hn[0, 1],
                                   c2 * Hn[0, 3])
            A, a = (freqs ** -2 * H24_n).sum(), H24_n.sum()
            B, b = (freqs ** -4 * H31_n).sum(), H31_n.sum()
            C, c = (freqs ** -2 * H21_n).sum(), H21_n.sum()
            D, d = (freqs ** -4 * H32_n).sum(), H32_n.sum()
            E, e = (freqs ** -2 * H22_n).sum(), H22_n.sum()
            F, f = (freqs ** -4 * H34_n).sum(), H34_n.sum()
            P4 = A * A * B + H44 * C * D + H14 * E * F - H44 * B * E - \
                A * C * F - H14 * A * D
            P3 = -2 * A * a * B - H44 * c * D - H14 * e * F + H44 * B * e + \
                (A * c + a * C) * F + H14 * a * D
            P2 = -(A * A * b - a * a * B) - H44 * C * d - H14 * E * f + \
                H44 * b * E + (A * C * f - a * c * F) + H14 * A * d
            P1 = 2 * A * a * b + H44 * c * d + H14 * e * f - H44 * b * e - \
                (A * c + a * C) * f - H14 * a * d
            P0 = -a * a * b + a * c * f
            coeffs = jnp.stack([P4, P3, P2, P1, P0])
        else:
            return [nu_DM, nu_GM, nu_tau]
        # roots are in u = nu^2 for this branch (reference takes roots**0.5)
        nu_zero = _nearest_positive_real_root(coeffs, freqs.mean(),
                                              square=True)
        return [nu_zero, nu_zero, nu_tau]

    # no zero-covariance frequencies for this flag combination
    return [nu_DM, nu_GM, nu_tau]


_ROOT_GRID = 2048     # log-grid points spanning 1e-3..1e3 x target
_ROOT_BISECT = 60     # bisection refinements per bracketed root


def _nearest_positive_real_root(coeffs, target, square=False):
    """Positive real root of the polynomial nearest the target frequency,
    entirely on device (jit/vmap-safe; no host callbacks and no
    nonsymmetric eigensolver).

    The polynomial (descending coefficients, variable v; v = nu^2 when
    square=True) is rescaled to v' = v/t and its coefficients normalized,
    then evaluated on a 1e-3..1e3 logarithmic grid of v'; every sign
    change is refined by masked bisection and the resulting root nearest
    the target is returned (the reference's np.roots pick,
    pptoaslib.py:806-811, 884-890; falls back to the target when no
    bracketed root exists).
    """
    coeffs = jnp.asarray(coeffs)
    dtype = coeffs.dtype
    target = jnp.asarray(target, dtype=dtype)
    t = target ** 2 if square else target
    deg = coeffs.shape[-1] - 1
    # scale the variable by t and normalize coefficients: c'_j = c_j t^(deg-j)
    powers = t ** jnp.arange(deg, -1, -1, dtype=dtype)
    cs = coeffs * powers
    norm = jnp.max(jnp.abs(cs))
    cs = cs / jnp.where(norm > 0.0, norm, 1.0)

    def horner(v):
        acc = jnp.broadcast_to(cs[0], v.shape)
        for j in range(1, deg + 1):
            acc = acc * v + cs[j]
        return acc

    grid = jnp.exp(jnp.linspace(jnp.log(jnp.asarray(1e-3, dtype)),
                                jnp.log(jnp.asarray(1e3, dtype)),
                                _ROOT_GRID).astype(dtype))
    pv = horner(grid)
    lo, hi = grid[:-1], grid[1:]
    plo, phi_v = pv[:-1], pv[1:]
    bracketed = (plo == 0.0) | (jnp.sign(plo) * jnp.sign(phi_v) < 0.0)

    def body(_, state):
        lo, hi, plo = state
        mid = 0.5 * (lo + hi)
        pm = horner(mid)
        go_left = jnp.sign(pm) * jnp.sign(plo) > 0.0
        lo2 = jnp.where(go_left, mid, lo)
        plo2 = jnp.where(go_left, pm, plo)
        hi2 = jnp.where(go_left, hi, mid)
        return lo2, hi2, plo2

    import jax
    lo_f, hi_f, _ = jax.lax.fori_loop(0, _ROOT_BISECT, body, (lo, hi, plo))
    roots_v = 0.5 * (lo_f + hi_f) * t          # back to physical v
    roots_nu = jnp.sqrt(roots_v) if square else roots_v
    dist = jnp.where(bracketed, jnp.abs(roots_nu - target), jnp.inf)
    best = jnp.argmin(dist)
    any_root = jnp.any(bracketed) & jnp.all(jnp.isfinite(cs))
    return jnp.where(any_root, roots_nu[best], target)
