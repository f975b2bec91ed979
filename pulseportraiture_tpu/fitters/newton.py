"""Jit-compiled trust-region Newton minimizer with exact Hessians.

Replaces the reference's scipy.optimize.minimize(method='trust-ncg'/
'Newton-CG'/'TNC') calls (pptoaslib.py:993-1014, pplib.py:2142-2148).  The
trust-region subproblem is solved *exactly* via the eigendecomposition of
the (tiny, <=5x5) Hessian plus a Newton iteration on the Moré–Sorensen
secular equation — affordable because the parameter space is small, and
fully vmappable because every step is fixed-shape (lax.while_loop with a
convergence mask).

Convergence is tighter than the reference's (gtol=-1 runs scipy until
trust-radius collapse): we stop on gradient norm, step size, or function
decrease, whichever first, then report a return code mirroring RCSTRINGS.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


def _dot(a, b):
    """Full-f32 dot for the <=5-wide Newton algebra (the GPU's default
    f32 dot precision is TF32)."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


# Return-code strings in the style of the reference's RCSTRINGS table
# (pplib.py:111-119, scipy TNC codes); our optimizer's statuses map to:
RCSTRINGS = {
    0: "Converged (gradient norm below tolerance)",
    1: "Converged (function decrease below ftol)",
    2: "Converged (step size / trust radius below xtol)",
    3: "Maximum number of iterations reached",
}


class NewtonResult(NamedTuple):
    x: jnp.ndarray
    fun: jnp.ndarray
    grad: jnp.ndarray
    hess: jnp.ndarray
    niter: jnp.ndarray
    nfev: jnp.ndarray
    status: jnp.ndarray  # 0 grad, 1 fconv, 2 xconv, 3 maxiter
    success: jnp.ndarray
    aux: object = None   # fgh aux pytree at x (has_aux=True only)


def _tr_solve(g, H, radius):
    """Exact trust-region step: argmin g.p + 0.5 p H p, |p| <= radius.

    The subproblem is solved on a scale-normalized copy (H/s, g/s with
    s = max|H|): the minimizer is identical and the Moré–Sorensen
    iteration stays conditioned for float32 objectives whose raw chi^2
    curvatures reach ~1e13.
    """
    s = jnp.maximum(jnp.max(jnp.abs(H)), jnp.asarray(1.0, H.dtype))
    g = g / s
    H = H / s
    lam, V = jnp.linalg.eigh(H)
    gt = _dot(V.T, g)
    lam_min = lam[0]
    eps = jnp.asarray(10.0, g.dtype) * jnp.finfo(g.dtype).eps

    def p_of(mu):
        return gt / (lam + mu)

    def norm_of(mu):
        return jnp.sqrt(jnp.sum(p_of(mu) ** 2) + eps * eps)

    # interior Newton step valid if H is PD and |p(0)| <= radius
    mu0 = jnp.maximum(0.0, -lam_min) + eps
    interior_ok = (lam_min > 0.0) & (norm_of(0.0) <= radius)

    # secular iteration on phi(mu) = 1/|p(mu)| - 1/radius (monotone in mu)
    def secular_body(_, mu):
        pn = norm_of(mu)
        phi = 1.0 / pn - 1.0 / radius
        # dphi/dmu = sum gt^2/(lam+mu)^3 / pn^3
        dphi = jnp.sum(gt ** 2 / (lam + mu) ** 3) / pn ** 3
        step = phi / jnp.where(dphi > 0.0, dphi, 1.0)
        mu_new = mu - step
        return jnp.maximum(mu_new, jnp.maximum(0.0, -lam_min) + eps)

    mu = jax.lax.fori_loop(0, 25, secular_body, mu0 + 1.0)
    p_boundary = -_dot(V, p_of(mu))
    # rescale exactly onto the boundary to protect against slow secular conv.
    pb_norm = jnp.sqrt(jnp.sum(p_boundary ** 2) + eps * eps)
    p_boundary = p_boundary * jnp.minimum(1.0, radius / pb_norm)
    p_interior = -_dot(V, p_of(0.0))
    p = jnp.where(interior_ok, p_interior, p_boundary)
    hit_boundary = ~interior_ok
    return p, hit_boundary


class _State(NamedTuple):
    x: jnp.ndarray
    f: jnp.ndarray
    g: jnp.ndarray
    H: jnp.ndarray
    radius: jnp.ndarray
    it: jnp.ndarray
    nfev: jnp.ndarray
    status: jnp.ndarray
    done: jnp.ndarray
    aux: object = None


def trust_region_minimize(fgh: Callable, x0, max_iter: int = 100,
                          gtol: float = 1e-10, xtol: float = 1e-12,
                          ftol: float = 0.0, init_radius: float = 1.0,
                          max_radius: float = 1e3, has_aux: bool = False,
                          step_mask=None):
    """Minimize f via exact trust-region Newton.

    fgh(x) -> (f, g, H) with analytic gradient/Hessian.  Non-fitted
    parameters must already be masked inside fgh (zero gradient row,
    identity Hessian row/col) so steps leave them unchanged.
    step_mask: optional (n,) 0/1 vector enforcing that invariant through
    the subproblem solve itself — _tr_solve normalizes H by max|H|, so a
    masked coordinate's identity diagonal becomes a near-zero eigenvalue
    that f32 eigh can cluster (and mix) with genuinely small curvature
    directions; the explicit projection pins the masked coordinates
    regardless of eigenvector rounding.
    has_aux: fgh returns (f, g, H, aux); the aux pytree of the accepted
    point is carried through the loop and returned (e.g. the harmonic
    moment reductions, so callers can re-derive per-channel Hessians /
    covariances without another pass over the spectra).
    """
    x0 = jnp.asarray(x0)
    if has_aux:
        f0, g0, H0, aux0 = fgh(x0)
    else:
        f0, g0, H0 = fgh(x0)
        aux0 = None
    dtype = f0.dtype

    g0norm = jnp.sqrt(jnp.sum(g0 ** 2))
    # dtype-aware relative gradient stop (f32 objectives cannot reach the
    # absolute f64-calibrated gtol)
    gtol_rel = 100.0 * jnp.finfo(dtype).eps

    mask = None if step_mask is None else jnp.asarray(step_mask, dtype)

    def _lookahead(f, g, H, radius, step_scale):
        """Speculative-final-step LOOKAHEAD.

        Solves the next trust-region subproblem from (g, H) already in
        hand and checks whether its predicted decrease sits below the
        floating-point resolution of f — the same condition the
        tiny_pred acceptance would discover one fgh evaluation later.
        When it does, the caller TAKES the step p without evaluating
        fgh at it: it is the same step the next iteration would have
        accepted (same g, H, radius -> same subproblem solution), so
        this saves one full pass over the spectra per batch — the
        vmapped while_loop runs max-over-batch iterations and the
        final iteration is almost always exactly this sub-floor step.
        Only f/g/H/aux stay one sub-floor step
        stale (pred <= 8 eps |f|, below what f32 can resolve in f).

        Because the step is NOT evaluated, it must stay inside the
        region where the quadratic model was just VERIFIED: |p| <=
        step_scale, the length of the last evaluation-checked accepted
        step.  Without the bound, a near-singular Hessian direction
        can carry |p| up to the trust radius while the (local!)
        quadratic model still predicts a sub-floor change — a jump the
        real optimizer's actual-decrease check would have rejected.
        The (<=5x5) subproblem re-solve costs microseconds."""
        p, _ = _tr_solve(g, H, radius)
        if mask is not None:
            p = p * mask
        pred = -(_dot(g, p) + 0.5 * _dot(p, _dot(H, p)))
        below = (pred >= 0.0) & \
            (pred <= 8.0 * jnp.finfo(dtype).eps * jnp.abs(f)) & \
            (jnp.sqrt(jnp.sum(p ** 2)) <= step_scale)
        return below, p

    st = _State(x=x0, f=f0, g=g0, H=H0,
                radius=jnp.asarray(init_radius, dtype),
                it=jnp.asarray(0), nfev=jnp.asarray(1),
                status=jnp.asarray(3), done=jnp.asarray(False),
                aux=aux0)

    def cond(st):
        return (~st.done) & (st.it < max_iter)

    def body(st):
        p, hit = _tr_solve(st.g, st.H, st.radius)
        if mask is not None:
            p = p * mask
        x_new = st.x + p
        if has_aux:
            f_new, g_new, H_new, aux_new = fgh(x_new)
        else:
            f_new, g_new, H_new = fgh(x_new)
            aux_new = None
        pred = -(_dot(st.g, p) + 0.5 * _dot(p, _dot(st.H, p)))
        actual = st.f - f_new
        rho = actual / jnp.where(pred > 0.0, pred, 1e-300)
        # when the predicted decrease is below the floating-point
        # resolution of f itself (huge raw chi2 in f32), rho is pure
        # rounding noise: accept the (trust-region) step and declare
        # ftol-convergence — the remaining improvement is unmeasurable
        eps_f = 8.0 * jnp.finfo(dtype).eps * jnp.abs(st.f)
        tiny_pred = (pred <= eps_f) & (actual >= -4.0 * eps_f)
        accept = (pred > 0.0) & ((rho > 0.15) | tiny_pred) & \
            jnp.isfinite(f_new)
        pnorm = jnp.sqrt(jnp.sum(p ** 2))
        # a non-finite trial value (e.g. 10**tau overflow) must SHRINK
        # the radius, or the same bad step is retried until max_iter
        bad = ~jnp.isfinite(rho) | ~jnp.isfinite(f_new)
        radius = jnp.where(bad | (rho < 0.25), 0.25 * pnorm,
                           jnp.where((rho > 0.75) & hit,
                                     jnp.minimum(2.0 * st.radius, max_radius),
                                     st.radius))
        x = jnp.where(accept, x_new, st.x)
        f = jnp.where(accept, f_new, st.f)
        g = jnp.where(accept, g_new, st.g)
        H = jnp.where(accept, H_new, st.H)
        aux = None
        if has_aux:
            aux = jax.tree_util.tree_map(
                lambda a, b: jnp.where(accept, a, b), aux_new, st.aux)
        gnorm = jnp.sqrt(jnp.sum(g ** 2))
        gconv = (gnorm < gtol) | (gnorm < gtol_rel * g0norm)
        xconv = accept & (pnorm < xtol)
        # speculative final step on the ACCEPTED point: when the next
        # subproblem's predicted decrease is below the f32 resolution
        # of f AND the step is no longer than the one just verified by
        # this evaluation, take it NOW (the same step the next
        # iteration would accept) and stop without paying its fgh
        # evaluation (non-accepted iterations keep stale g/H and must
        # re-iterate)
        below2, p2 = _lookahead(f, g, H, radius, pnorm)
        spec = accept & below2
        x = jnp.where(spec, x + p2, x)
        fconv = (accept & (ftol > 0.0) & (actual < ftol * jnp.maximum(
            jnp.abs(st.f), 1.0))) | (accept & tiny_pred & (pred > 0.0)) | \
            spec
        stalled = (~accept) & (radius < xtol)
        done = gconv | xconv | fconv | stalled
        status = jnp.where(gconv, 0,
                           jnp.where(fconv, 1, jnp.where(xconv | stalled, 2,
                                                         st.status)))
        return _State(x=x, f=f, g=g, H=H, radius=radius, it=st.it + 1,
                      nfev=st.nfev + 1, status=status, done=done, aux=aux)

    st = jax.lax.while_loop(cond, body, st)
    return NewtonResult(x=st.x, fun=st.f, grad=st.g, hess=st.H,
                        niter=st.it, nfev=st.nfev, status=st.status,
                        success=st.status < 3, aux=st.aux)
