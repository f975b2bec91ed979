"""Model-band harmonic cap and the capped direct-DFT fit setup.

The fit setup needs Gr/Gi = split-real d_FT * conj(m_FT) from the
time-domain data.  A narrow template's spectrum is identically zero
(after band_cap_model_ft's cleaning) above a few hundred harmonics, so
only k < NQ*M' (nbin = NQ * 128, M' = mharm) need storing.
direct_capped_setup computes just those harmonics as one plain-XLA
(B*nchan, nbin) @ (nbin, NH+1) matmul, which partitions under GSPMD.

The capped outputs are stored in **CT-permuted harmonic order**:
position p = u*M' + m holds harmonic k = NQ*m + u (the order of a
Cooley-Tukey split nbin = NQ * 128).  Every downstream reduction
(moments, Hessians, scales) is order-free given the per-position k
vector (`ct_kvec`).  The full layout (mharm=None) appends the Nyquist
harmonic, NH == nbin/2 + 1: the natural-order storage, permuted.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_LANES = 128


def ct_supported(nbin: int) -> bool:
    """The CT layout applies when nbin = NQ * 128 with NQ even in
    [2, 32]."""
    NQ = nbin // _LANES
    return nbin % _LANES == 0 and 2 <= NQ <= 32 and NQ % 2 == 0


def ct_geometry(nbin: int, mharm=None):
    """(NQ, M0, NH): q-factor, per-u block size, stored harmonics.
    Layout: position p = u*M0 + m holds harmonic k = NQ*m + u for
    p < NQ*M0; in the FULL layout (mharm=None, M0=64) the final
    position NH-1 additionally holds the Nyquist harmonic k = nbin/2,
    so NH == nbin/2 + 1 — identical storage to the natural order, just
    permuted.

    mharm = M' < 64 selects the **model-band harmonic cap**: only
    harmonics k < NQ*M' are stored (NH = NQ*M', no Nyquist slot).
    Exact whenever the model spectrum is identically zero at k >=
    NQ*M' (see suggest_mharm): every dropped Gr/Gi/M2 element would be
    exactly 0 and contributes nothing to any moment; sd switches to
    the Parseval form so chi2 keeps the full data power."""
    NQ = nbin // _LANES
    if mharm is None:
        M0 = nbin // 2 // NQ      # == 64
        return NQ, M0, NQ * M0 + 1
    assert 0 < mharm < nbin // 2 // NQ and mharm % 8 == 0, \
        "mharm must be a positive multiple of 8 below 64"
    return NQ, mharm, NQ * mharm


@functools.lru_cache(maxsize=16)
def ct_perm_np(nbin: int, mharm=None):
    """kvec: per-position harmonic number, length NH (full layout: a
    permutation of 0..nbin/2; capped: of 0..NQ*mharm-1)."""
    NQ, M0, NH = ct_geometry(nbin, mharm)
    p = np.arange(NQ * M0)
    k = NQ * (p % M0) + p // M0
    if mharm is not None:
        return k
    return np.concatenate([k, [nbin // 2]])


def ct_kvec(nbin: int, dtype=np.float32, mharm=None):
    """Per-position harmonic numbers as a float vector (NH,)."""
    return ct_perm_np(nbin, mharm).astype(dtype)


def permute_spectrum(re, im, nbin, mharm=None):
    """Natural-order split spectrum (..., nharm) -> CT order (..., NH)
    (one cheap gather at setup time)."""
    src = ct_perm_np(nbin, mharm).astype(np.int64)
    re = jnp.asarray(re)
    im = jnp.asarray(im)
    return re[..., src], im[..., src]


def suggest_mharm(mr, mi, nbin):
    """Model-band harmonic cap M' for a HOST natural-order split-real
    model spectrum, or None when capping is not applicable.

    Returns the smallest multiple of 8 with every harmonic k >= NQ*M'
    identically zero in f32 across all channels (so the capped CT
    layout is exact, ct_geometry).  Use band_cap_model_ft to produce
    such a spectrum — no floating-point rFFT yields genuine zeros on
    its own (f64 FFT rounding floors at ~1e-15 relative)."""
    if not ct_supported(nbin):
        return None
    NQ, M0, _ = ct_geometry(nbin)
    a = (np.abs(np.asarray(mr, np.float32)) +
         np.abs(np.asarray(mi, np.float32)))
    if a.ndim > 1:
        a = a.max(axis=tuple(range(a.ndim - 1)))
    nz = np.nonzero(a)[0]
    if len(nz) == 0:
        return None
    k_last = int(nz[-1])
    mh = -(-(k_last + 1) // NQ)
    mh += (-mh) % 8
    if mh >= M0:
        return None
    return mh


def band_cap_model_ft(mr, mi, nbin, rel_floor=1e-6, f0_fact=None):
    """Clean + cap a HOST natural-order split-real model spectrum for
    the model-band harmonic cap: returns (mr2, mi2, mharm).

    Harmonics whose amplitude (across every channel) is below
    rel_floor * max amplitude are zeroed; mharm is the resulting cap
    (ct_geometry), or None when the band extends too far for capping
    to pay.  The default floor, 1e-6 relative, sits below the f32
    arithmetic noise the fit already carries (the stored time-domain
    model is f32, which itself injects a ~1e-7 relative white floor
    across the whole band), so dropping these harmonics perturbs the
    fitted (phi, DM) by less than the existing f32 rounding budget —
    a numerical cleanup, not a modeling change.  The threshold is
    explicit because no floating-point rFFT produces genuine zeros
    (f64 FFT rounding floors at ~1e-15 relative).

    f0_fact (default config.F0_FACT): when falsy, the DC harmonic is
    zeroed to match stats.model_ft's convention (reference
    pptoaslib.py F0_fact; the fit's M2/S0/chi2 are DC-less) — callers
    feed raw np.fft.rfft output, which otherwise carries the model's
    large mean-flux DC term into S0 and inflates chi2/scales."""
    if f0_fact is None:
        from pulseportraiture_tpu.config import F0_FACT
        f0_fact = F0_FACT
    mr = np.asarray(mr, np.float32).copy()
    mi = np.asarray(mi, np.float32).copy()
    if not f0_fact:
        mr[..., 0] = 0.0
        mi[..., 0] = 0.0
    a = np.abs(mr) + np.abs(mi)
    if a.ndim > 1:
        a = a.max(axis=tuple(range(a.ndim - 1)))
    dead = a < rel_floor * a.max()
    mr[..., dead] = 0.0
    mi[..., dead] = 0.0
    return mr, mi, suggest_mharm(mr, mi, nbin)


def unpermute_spectrum(re_p, im_p, nbin):
    """CT order (..., NH) -> natural order (..., nharm)."""
    kvec = ct_perm_np(nbin)
    pos = np.zeros(nbin // 2 + 1, dtype=np.int64)
    pos[kvec] = np.arange(len(kvec))
    return re_p[..., pos], im_p[..., pos]


# The pipeline's mesh route takes the capped direct setup below this
# model-band cap and the full-band sharded setup above it.  The
# threshold is where the capped setup stopped paying on the machine the
# code was first tuned for; its crossover on the H100 is not measured.
DIRECT_MHARM_MAX = 16


def dot_precision(dft_precision):
    """lax dot precision for a DFT matmul: "highest" -> full f32;
    "high" -> three bf16 passes with f32 accumulation, about 2^-21
    relative.  Never TF32, which keeps about three decimal digits and
    breaks the 1e-9 dDM budget."""
    name = (dft_precision or "high").lower()
    if name == "highest":
        return jax.lax.Precision.HIGHEST
    if name == "high":
        return jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    raise ValueError(f"dft_precision must be 'high' or 'highest', got "
                     f"{dft_precision!r}")


@functools.lru_cache(maxsize=8)
def _direct_consts_np(nbin: int, mharm: int):
    """Host trig matrices for the capped DIRECT DFT-matmul setup, with
    columns already in CT-permuted order (position p holds harmonic
    kvec[p]) plus one extra cos column for the Nyquist sum (Parseval
    sd).  Built in f64, cast f32."""
    kv = ct_perm_np(nbin, mharm).astype(np.float64)
    j = np.arange(nbin, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * j * kv[None, :] / nbin
    Ec = np.concatenate([np.cos(ang), np.cos(np.pi * j)], axis=1)
    return Ec.astype(np.float32), np.sin(ang).astype(np.float32)


def direct_capped_setup(x, mr_p, mi_p, f0_fact=False,
                        dft_precision="high", w=None, scale=None,
                        mharm=None):
    """Capped fit setup as one direct DFT matmul over the kept harmonics.

    x: (B, nchan, nbin) or (nchan, nbin) data (f32, or int16 with the
    per-channel dequantization `scale`); mr_p/mi_p: the shared model
    spectrum in the capped CT-permuted order (permute_spectrum).
    Returns Gr/Gi (..., nchan, NH), the per-channel data power sd over
    ALL harmonics (Parseval, so chi2 keeps the full data power), and
    with seed weights w also the band sums gsr/gsi (..., [K,] NH) that
    feed the brute (phi, DM) seed.  Plain XLA, so it partitions under
    GSPMD (parallel/mesh.py fit_portrait_full_sharded_direct).
    dft_precision: see dot_precision.
    """
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    B, nchan, nbin = x.shape
    assert mharm is not None, "direct_capped_setup requires the cap"
    NQ, M0, NH = ct_geometry(nbin, mharm)
    assert mr_p.shape[-1] == NH, \
        f"model spectrum has {mr_p.shape[-1]} positions, layout wants {NH}"
    prec = dot_precision(dft_precision)
    Ecnp, Esnp = _direct_consts_np(nbin, mharm)
    Ec = jnp.asarray(Ecnp)
    Es = jnp.asarray(Esnp)
    mr_p = mr_p.astype(jnp.float32)
    mi_p = mi_p.astype(jnp.float32)
    xf = x.astype(jnp.float32)
    Xr_full = jnp.matmul(xf, Ec, precision=prec,
                         preferred_element_type=jnp.float32)
    Xi = -jnp.matmul(xf, Es, precision=prec,
                     preferred_element_type=jnp.float32)
    sx2 = jnp.sum(xf * xf, axis=-1)
    if scale is not None:
        # int16-native ingest: per-channel dequantize applied AFTER the
        # DFT (the transform is linear in the per-channel scale); the
        # per-profile offsets only feed the DC harmonic, which F0_FACT
        # zeroing discards
        assert not f0_fact, \
            "int16 ingest drops per-channel offsets into the DC " \
            "harmonic; it requires F0_FACT zeroing"
        scale = jnp.broadcast_to(jnp.asarray(scale, jnp.float32),
                                 (B, nchan))
        Xr_full = Xr_full * scale[..., None]
        Xi = Xi * scale[..., None]
        sx2 = sx2 * scale * scale
    Xr, ny = Xr_full[..., :NH], Xr_full[..., NH]
    x0 = Xr[..., 0]          # position 0 holds harmonic k = 0
    # Parseval data power over ALL harmonics k=1..nbin/2 (plus DC when
    # f0_fact keeps it) — exact regardless of the cap
    sd = 0.5 * (jnp.float32(nbin) * sx2 - x0 * x0) + 0.5 * ny * ny
    if f0_fact:
        sd = sd + x0 * x0
    Gr = Xr * mr_p + Xi * mi_p
    Gi = Xi * mr_p - Xr * mi_p
    if not f0_fact:
        Gr = Gr.at[..., 0].set(0.0)
        Gi = Gi.at[..., 0].set(0.0)
    if w is not None:
        # w may carry K stacked seed-weight vectors (..., nchan, K) —
        # e.g. (full-band, upper-half) for the fused (phi, DM) seed
        # (fitters.portrait _seed_phi_dm); plain (nchan,)/(B, nchan)
        # weights keep the single band-summed output shape
        w3, stacked = _seed_weights(w, B, nchan)
        hi = jax.lax.Precision.HIGHEST
        gsr = jnp.einsum("bcs,bck->bsk", w3, Gr, precision=hi)
        gsi = jnp.einsum("bcs,bck->bsk", w3, Gi, precision=hi)
        if not stacked:
            gsr, gsi = gsr[:, 0], gsi[:, 0]
        if squeeze:
            return Gr[0], Gi[0], sd[0], gsr[0], gsi[0]
        return Gr, Gi, sd, gsr, gsi
    if squeeze:
        return Gr[0], Gi[0], sd[0]
    return Gr, Gi, sd


def _seed_weights(w, B, nchan):
    """Normalize seed weights to (B, nchan, K); returns (w3, stacked).

    stacked (K seed vectors, e.g. (full-band, upper-half) for the
    fused (phi, DM) seed) requires an EXPLICIT 3-D (B, nchan, K) —
    1-D (nchan,) and 2-D (B, nchan) are always the legacy single
    weight vector (K=1, squeezed on output)."""
    w = jnp.asarray(w, jnp.float32)
    if w.ndim == 3:
        assert w.shape[1] == nchan, \
            f"stacked seed weights are (B, nchan, K); got {w.shape}"
        return jnp.broadcast_to(w, (B, nchan, w.shape[-1])), True
    return jnp.broadcast_to(w, (B, nchan))[..., None], False
