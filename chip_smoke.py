#!/usr/bin/env python
"""Smoke test of the wideband TOA path on one GPU, at 4096ch x 2048bin.

    python chip_smoke.py [--seed 0] [--mesh 4]

Phases (each prints its seconds; any failure exits non-zero with no
result line):

1. setup parity: stats.make_setup (rFFT cross-spectrum) and the XLA
   phase and scattering moments at a fixed theta, against the float64
   NumPy reference (fitters/reference.py), for 4 items;
2. noiseless fit: fit_portrait_full_batch in float32 on 16 items with
   injected (phi, DM), against the truth; plus one noisy scattered item
   with fit_flags=(1,1,0,1,1), whose tau and alpha must come back within
   3 sigma;
3. campaign: 8 archives x 4 subints of int16 PSRFITS from --seed, then
   the ppalign, ppspline, pptoas and ppzap command-line tools; every
   archive's fitted DeltaDM within 5 sigma of the injection, median
   reduced chi2 in [0.9, 1.1].

--mesh N runs only the multi-device phase on N devices: pptoas on one
device against GetTOAs(mesh=...) on (N, 1) and (N/2, 2) meshes, for a
wide pulse whose spectrum caps (the capped direct route) and a narrow
one whose does not (the shard_map route), within 0.01 sigma; and no
spectra-sized collective in the compiled mesh programs.

Needs a GPU: with any other JAX platform it exits 1.  The last line of
standard output is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

NCHAN, NBIN = 4096, 2048
P0 = 0.003                        # spin period of the fit phases [s]
# two-component template whose width and amplitude evolve over the band
CAMPAIGN_MODEL = [0.0, 0.0, 0.2193, -0.0052, 0.0482, -2.08, 5.13, -1.66,
                  0.2341, -0.0027, 0.0157, 1.615, 9.46, -2.08]
# one narrow component: its band reaches past the direct-setup cap
WIDEBAND_MODEL = [0.0, 0.0, 0.30, 0.0, 0.004, 0.0, 5.0, 0.0]
# one wide, evolving component: its band caps below DIRECT_MHARM_MAX
# from 1024 bins up
CAPPED_MODEL = [0.0, 0.0, 0.30, 0.0, 0.05, -0.5, 5.0, -1.5]
PAR = ("PSR J0000+00\nRAJ 00:01:02\nDECJ 03:04:05\n"
       "F0 345.678901234\nPEPOCH 50000\nDM 34.5678\n")


def _template(nchan, nbin):
    """float64 (nchan, nbin) two-Gaussian portrait with spectral index."""
    freqs = np.linspace(1100.0, 1900.0, nchan)
    x = (np.arange(nbin) + 0.5) / nbin
    prof = np.exp(-0.5 * ((x - 0.4) / 0.02) ** 2) + \
        0.4 * np.exp(-0.5 * ((x - 0.47) / 0.01) ** 2)
    return freqs, prof[None, :] * (freqs[:, None] / 1500.0) ** -1.5


def _relmax(a, b):
    b = np.asarray(b, np.float64)
    return float(np.abs(np.asarray(a, np.float64) - b).max() /
                 max(np.abs(b).max(), 1e-300))


def phase_setup_parity(nchan=NCHAN, nbin=NBIN, B=4, seed=0, tol=1e-5):
    """Device setup and moments against the float64 NumPy reference;
    returns the max relative error.  Gr/Gi/sd errors are relative to
    each array's max; a moment's error is relative to the largest sum
    of its terms' magnitudes, the scale float32 rounding of a sum of
    ~nbin/2 terms is proportional to."""
    import jax
    import jax.numpy as jnp

    from pulseportraiture_tpu.fitters import reference, stats

    rng = np.random.default_rng(seed)
    freqs, model = _template(nchan, nbin)
    data = (model[None] + rng.normal(0, 0.1, (B, nchan, nbin))).astype(
        np.float32)
    model32 = model.astype(np.float32)
    fr = jnp.asarray(freqs, jnp.float32)
    nu = float(freqs.mean())

    @jax.jit
    def setup(d, m):
        mft = stats.model_ft(m)
        return jax.vmap(lambda x: stats.make_setup(
            x, None, jnp.full(nchan, 0.1, jnp.float32), P0, fr, nu, nu, nu,
            model_ft_ri=mft))(d)

    s = setup(jnp.asarray(data), jnp.asarray(model32))
    G, sd = reference.cross_spectrum(data, model32)
    w = float(np.asarray(s.w)[0, 0])
    errs = {"Gr": _relmax(s.Gr, G.real), "Gi": _relmax(s.Gi, G.imag),
            "sd": _relmax(np.asarray(s.sd_chan) / w, sd)}
    theta = jnp.asarray([0.1, 1e-3, 0.0, -3.0, -4.0], jnp.float32)
    s0 = jax.tree_util.tree_map(lambda a: a[0], s._replace(nbin=None))
    s0 = s0._replace(nbin=nbin)
    # the moments are checked on the device's own spectra, phases and
    # taus (as float64), so that only the reductions are compared: the
    # spectra were checked above, and a float32 rFFT's rounding floor
    # at high harmonics, weighted by k**2, would swamp them
    G0 = np.asarray(s0.Gr, np.float64) + 1j * np.asarray(s0.Gi, np.float64)
    M2 = np.asarray(s0.M2, np.float64)
    for scattering in (False, True):
        got = jax.jit(lambda st: stats._moments(
            theta, st, True, order=2, scattering=scattering))(s0)
        args = (theta, G0, M2, np.asarray(s0.w), freqs, P0, nu, nu, nu)
        kw = dict(phis=got["phis"], taus=got["taus"])
        want = reference.moments(*args, **kw)
        mag = reference.moments(*args, magnitude=True, **kw)
        keys = ("C", "S", "Cp", "Cpp") + (
            ("Rf", "S1", "If1", "Rg", "S2") if scattering else ())
        tag = "scat" if scattering else "phase"
        for key in keys:
            errs[f"{tag}_{key}"] = float(
                np.abs(np.asarray(got[key], np.float64) - want[key]).max()
                / max(mag[key].max(), 1e-300))
    bad = {k: v for k, v in errs.items() if not v <= tol}
    assert not bad, f"setup/moments relative error above {tol}: {bad}"
    return {"max_rel_err": max(errs.values())}


def _shifted(model, freqs, phis, dms, nu_fit):
    """float64 data portraits: the model shifted by (phi, DM) per item."""
    from pulseportraiture_tpu.config import DCONST

    mfft = np.fft.rfft(model, axis=-1)
    k = 2j * np.pi * np.arange(model.shape[-1] // 2 + 1)
    out = np.empty((len(phis),) + model.shape)
    for i, (phi, dm) in enumerate(zip(phis, dms)):
        shift = phi + DCONST * dm / P0 * (freqs ** -2 - nu_fit ** -2)
        out[i] = np.fft.irfft(mfft * np.exp(-k * shift[:, None]),
                              n=model.shape[-1], axis=-1)
    return out


def phase_noiseless_fit(nchan=NCHAN, nbin=NBIN, B=16, seed=0,
                        dtype=np.float32, tol_phi=2e-7, tol_dm=1e-9):
    """Batched (phi, DM) fit of noiseless shifted data against the truth,
    and one noisy scattered (phi, DM, tau, alpha) fit within 3 sigma."""
    import jax
    import jax.numpy as jnp

    from pulseportraiture_tpu.fitters.portrait import \
        fit_portrait_full_batch
    from pulseportraiture_tpu.ops.ct_dft import band_cap_model_ft
    from pulseportraiture_tpu.ops.scattering import scattering_times
    from pulseportraiture_tpu.ops.transform import phase_transform

    rng = np.random.default_rng(seed)
    freqs, model = _template(nchan, nbin)
    nu_fit = float(freqs.mean())
    phis = rng.uniform(-0.01, 0.01, B)
    dms = rng.uniform(-2e-4, 2e-4, B)
    data = _shifted(model, freqs, phis, dms, nu_fit)
    mf64 = np.fft.rfft(model, axis=-1)
    mr, mi, _ = band_cap_model_ft(mf64.real, mf64.imag, nbin)
    res = fit_portrait_full_batch(
        jnp.asarray(data, dtype), jnp.asarray(model, dtype),
        jnp.zeros((B, 5), dtype), jnp.full(B, P0, dtype),
        jnp.asarray(freqs, dtype), jnp.full((B, nchan), 0.1, dtype),
        nu_fits=jnp.full((B, 3), nu_fit, dtype), fit_flags=(1, 1, 0, 0, 0),
        log10_tau=False, max_iter=30, scattering=False, seed_phase=True,
        model_ft_ri=(jnp.asarray(mr), jnp.asarray(mi)))
    params = np.asarray(res.params, np.float64)
    phi_fit = np.asarray(jax.vmap(
        lambda p, d, n: phase_transform(p, d, n, nu_fit, P0, mod=True))(
        jnp.asarray(params[:, 0]), jnp.asarray(params[:, 1]),
        jnp.asarray(np.asarray(res.nu_DM, np.float64))))
    dphi = float(np.abs((phi_fit - phis + 0.5) % 1.0 - 0.5).max())
    ddm = float(np.abs(params[:, 1] - dms).max())
    assert dphi <= tol_phi and ddm <= tol_dm, \
        f"noiseless fit: max|dphi| {dphi:.3e} (<= {tol_phi}), " \
        f"max|dDM| {ddm:.3e} (<= {tol_dm})"

    # one scattered item, 5-parameter fit with noise
    tau0, alpha0, nu_r, sigma = 8.0 / nbin, -4.2, 1500.0, 0.05
    taus = np.asarray(scattering_times(tau0, alpha0, freqs, nu_r))
    k = np.arange(nbin // 2 + 1)
    scat = np.fft.irfft(mf64 / (1.0 + 2j * np.pi * np.outer(taus, k)),
                        n=nbin, axis=-1)
    scat = scat + rng.normal(0, sigma, scat.shape)
    init = np.array([[0.0, 0.0, 0.0, 0.5 * tau0, -4.0]])
    rs = fit_portrait_full_batch(
        jnp.asarray(scat[None], dtype), jnp.asarray(model, dtype),
        jnp.asarray(init, dtype), jnp.full(1, P0, dtype),
        jnp.asarray(freqs, dtype), jnp.full((1, nchan), sigma, dtype),
        nu_fits=jnp.full((1, 3), nu_r, dtype), fit_flags=(1, 1, 0, 1, 1),
        log10_tau=False, max_iter=60, scattering=True)
    p = np.asarray(rs.params, np.float64)[0]
    pe = np.asarray(rs.param_errs, np.float64)[0]
    tau_true = tau0 * (float(np.asarray(rs.nu_tau)[0]) / nu_r) ** alpha0
    ntau = abs(p[3] - tau_true) / pe[3]
    nalpha = abs(p[4] - alpha0) / pe[4]
    assert ntau <= 3.0 and nalpha <= 3.0, \
        f"scattering fit off: tau {ntau:.2f} sigma, alpha {nalpha:.2f} " \
        "sigma"
    return {"max_dphi": dphi, "max_dDM": ddm, "tau_sigma": float(ntau),
            "alpha_sigma": float(nalpha)}


def _write_inputs(work, params, tag="c"):
    from pulseportraiture_tpu.models.gmodel_io import write_model

    gmodel = os.path.join(work, f"{tag}.gmodel")
    write_model(gmodel, "SMOKE", "000", 1500.0, params,
                [1] * len(params), -4.0, 0, quiet=True)
    par = os.path.join(work, "p.par")
    with open(par, "w") as f:
        f.write(PAR)
    return gmodel, par


def _make_archives(work, gmodel, par, narch, nsub, nchan, nbin, seed,
                   tag="c"):
    """int16 PSRFITS archives with injected per-archive dDM."""
    from pulseportraiture_tpu.io.mjd import MJD
    from pulseportraiture_tpu.sim.fake import make_fake_pulsar

    dDMs = np.random.default_rng(seed).normal(3e-4, 2e-4, narch)
    files = []
    for i in range(narch):
        path = os.path.join(work, f"{tag}{i:02d}.fits")
        make_fake_pulsar(gmodel, par, outfile=path, nsub=nsub, npol=1,
                         nchan=nchan, nbin=nbin, nu0=1500.0, bw=800.0,
                         tsub=60.0, dDM=dDMs[i],
                         start_MJD=MJD(57000.0 + 2.0 * i), noise_stds=0.5,
                         dedispersed=False, quiet=True,
                         rng=np.random.default_rng(seed * 1000 + i))
        files.append(path)
    return files, dDMs


class _Recorder:
    """Wraps pipelines.toas.GetTOAs so the pipelines a CLI builds can be
    inspected after it returns."""

    def __init__(self):
        from pulseportraiture_tpu.pipelines import toas
        self.module, self.real, self.made = toas, toas.GetTOAs, []
        rec = self

        class GetTOAs(toas.GetTOAs):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                rec.made.append(self)

        self.cls = GetTOAs

    def __enter__(self):
        self.module.GetTOAs = self.cls
        return self

    def __exit__(self, *exc):
        self.module.GetTOAs = self.real


@contextlib.contextmanager
def _route_spy(module, names):
    """Yields the list of which of module's functions `names` were
    called inside the block."""
    taken, real = [], {n: getattr(module, n) for n in names}

    def wrap(name):
        def spy(*a, **k):
            taken.append(name)
            return real[name](*a, **k)
        return spy

    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield taken
    finally:
        for n, f in real.items():
            setattr(module, n, f)


def phase_campaign(nchan=NCHAN, nbin=NBIN, narch=8, nsub=4, seed=0,
                   work=None):
    """Archives on disk -> ppalign -> ppspline -> pptoas -> ppzap."""
    from pulseportraiture_tpu.cli import (ppalign, ppspline, pptoas,
                                          ppzap)
    from pulseportraiture_tpu.io.mjd import MJD
    from pulseportraiture_tpu.sim.fake import make_fake_pulsar

    work = work or tempfile.mkdtemp(prefix="chip_smoke_")
    gmodel, par = _write_inputs(work, CAMPAIGN_MODEL)
    t0 = time.perf_counter()
    files, dDMs = _make_archives(work, gmodel, par, narch, nsub, nchan,
                                 nbin, seed)
    # noiseless alignment seed at the ephemeris DM: anchors the
    # template's DM zero point
    init = os.path.join(work, "init.fits")
    make_fake_pulsar(gmodel, par, outfile=init, nsub=1, npol=1,
                     nchan=nchan, nbin=nbin, nu0=1500.0, bw=800.0,
                     tsub=60.0, start_MJD=MJD(57000.0), noise_stds=0.0,
                     dedispersed=True, quiet=True)
    meta = os.path.join(work, "files.meta")
    with open(meta, "w") as f:
        f.write("\n".join(files) + "\n")
    t_gen = time.perf_counter() - t0

    t = {}
    t0 = time.perf_counter()
    tmpl = os.path.join(work, "template.fits")
    assert ppalign.main(["-M", meta, "-I", init, "-o", tmpl, "-T",
                         "--quiet"]) == 0
    t["ppalign_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spl = os.path.join(work, "template.spl")
    assert ppspline.main(["-d", tmpl, "-o", spl, "-s", "--quiet"]) == 0
    t["ppspline_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tim = os.path.join(work, "campaign.tim")
    with _Recorder() as rec:
        assert pptoas.main(["-d", meta, "-m", spl, "-o", tim,
                            "--quiet"]) == 0
    t["pptoas_s"] = time.perf_counter() - t0
    gt = rec.made[-1]
    t0 = time.perf_counter()
    zapped = os.path.join(work, "zapped.fits")
    assert ppzap.main(["-d", files[0], "-m", spl, "-o", zapped,
                       "--quiet"]) == 0
    assert os.path.exists(zapped)
    t["ppzap_s"] = time.perf_counter() - t0

    ntoa = len(gt.TOA_list)
    assert ntoa == narch * nsub, ntoa
    dd = np.asarray(gt.DeltaDM_means, np.float64)
    de = np.asarray(gt.DeltaDM_errs, np.float64)
    nsig = np.abs(dd - dDMs) / de
    assert np.all(nsig <= 5.0), f"DeltaDM off by {nsig.max():.2f} sigma"
    rchi2 = float(np.median(np.concatenate(
        [np.ravel(r) for r in gt.red_chi2s])))
    assert 0.9 <= rchi2 <= 1.1, f"median reduced chi2 {rchi2:.3f}"
    timing = {k: round(v, 3) for k, v in gt.fit_timing.items()}
    return {"gen_s": round(t_gen, 1), **{k: round(v, 1) for k, v in
                                         t.items()},
            "toas_per_s": round(ntoa / t["pptoas_s"], 2),
            "gettoas_timing": timing, "max_dDM_sigma": float(nsig.max()),
            "median_red_chi2": rchi2}


def _collective_sizes(hlo, ops=("all-gather", "all-reduce", "all-to-all",
                                "collective-permute")):
    """Element counts of every collective's result in HLO text."""
    import re

    out = []
    for line in hlo.splitlines():
        for op in ops:
            if f" {op}(" not in line and f"{op}-start(" not in line:
                continue
            lhs = line.split("=", 1)
            if len(lhs) < 2:
                continue
            for dims in re.findall(r"\[([0-9,]*)\]", lhs[1].split(op)[0]):
                n = 1
                for d in dims.split(","):
                    if d:
                        n *= int(d)
                out.append((op, n))
    return out


def phase_mesh(ndev, nchan=NCHAN, nbin=NBIN, narch=4, nsub=4, seed=0,
               work=None, tol_sigma=0.01):
    """pptoas through GetTOAs(mesh=...) against one device, for both
    mesh routes, and the compiled mesh programs' collectives."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as Pspec

    from pulseportraiture_tpu.config import DCONST
    from pulseportraiture_tpu.fitters.portrait import \
        fit_portrait_full_batch_packed
    from pulseportraiture_tpu.parallel import mesh as pmesh
    from pulseportraiture_tpu.parallel.mesh import _sharded_fit, make_mesh
    from pulseportraiture_tpu.pipelines.toas import GetTOAs

    assert len(jax.devices()) >= ndev, \
        f"--mesh {ndev} needs {ndev} devices, have {len(jax.devices())}"
    work = work or tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    meshes = {f"{ndev}x1": make_mesh(ndev, 1),
              f"{ndev // 2}x2": make_mesh(ndev // 2, 2)}
    routes = {"direct": "fit_portrait_full_sharded_direct",
              "shard_map": "fit_portrait_full_sharded"}
    out = {}
    for name, params in (("direct", CAPPED_MODEL),
                         ("shard_map", WIDEBAND_MODEL)):
        gmodel, par = _write_inputs(work, params, tag=name)
        files, _ = _make_archives(work, gmodel, par, narch, nsub, nchan,
                                  nbin, seed, tag=name)
        ref = GetTOAs(files, gmodel, quiet=True)
        ref.get_TOAs(quiet=True)
        for mname, mesh in meshes.items():
            t0 = time.perf_counter()
            with _route_spy(pmesh, list(routes.values())) as taken:
                gt = GetTOAs(files, gmodel, quiet=True)
                gt.get_TOAs(quiet=True, mesh=mesh)
            dt = time.perf_counter() - t0
            assert taken and set(taken) == {routes[name]}, \
                f"{name} archives on {mname} took {taken}"
            assert len(gt.TOA_list) == len(ref.TOA_list) == narch * nsub
            worst = 0.0
            for a, b in zip(gt.TOA_list, ref.TOA_list):
                # the fitted reference frequencies are float32 and may
                # differ by an ulp: compare arrival times at b's
                # frequency (MJD difference in s, TOA_error in us)
                dt_s = (a.MJD - b.MJD) + DCONST * a.DM * (
                    b.frequency ** -2 - a.frequency ** -2)
                worst = max(worst, abs(dt_s) * 1e6 / b.TOA_error,
                            abs(a.DM - b.DM) / b.DM_error)
            assert worst <= tol_sigma, \
                f"{name} route on {mname}: {worst:.4f} sigma"
            out[f"{name}_{mname}_sigma"] = worst
            out[f"{name}_{mname}_s"] = round(dt, 1)

    # compiled mesh programs: no spectra-sized collective
    nharm = nbin // 2 + 1
    B = 32
    mesh = meshes[f"{ndev // 2}x2"]

    def spec(shape, dt, *axes):
        return jax.ShapeDtypeStruct(shape, dt,
                                    sharding=NamedSharding(mesh,
                                                           Pspec(*axes)))

    f32 = jnp.float32
    args = (spec((B, nchan, nbin), jnp.int16, "batch", "chan", None),
            spec((nchan, nbin), f32, "chan", None),
            spec((B, 5), f32, "batch"), spec((B,), f32, "batch"),
            spec((B, nchan), f32, "batch", "chan"),
            spec((B, nchan), f32, "batch", "chan"))
    chan_args = (spec((B, nchan), f32, "batch", "chan"),
                 spec((B, 3), f32, "batch"))
    scales = spec((B, nchan), f32, "batch", "chan")
    mft = (spec((nchan, nharm), f32, "chan", None),) * 2
    hlo_sharded = _sharded_fit.lower(
        mesh, *args, *chan_args, scales, mft, fit_flags=(1, 1, 0, 0, 0),
        log10_tau=True, max_iter=100, scattering=False, seed_phase=True,
        packed=True).compile().as_text()
    # the capped program at the smallest cap (ops.ct_dft.ct_geometry):
    # the cap sets the spectra's width, not which collectives appear
    hlo_direct = fit_portrait_full_batch_packed.lower(
        *args, weights=chan_args[0], nu_fits=chan_args[1],
        fit_flags=(1, 1, 0, 0, 0), log10_tau=True, max_iter=100,
        scattering=False, dft_precision="high", ct=True, seed_phase=True,
        seed_dm=True, scales=scales, model_ft_ri=mft,
        mharm=8).compile().as_text()
    limit = nchan * nharm // 2
    for name, hlo in (("shard_map", hlo_sharded), ("direct", hlo_direct)):
        sizes = _collective_sizes(hlo)
        big = [s for s in sizes if s[1] >= limit]
        assert not big, f"{name} route: spectra-sized collectives {big}"
        out[f"{name}_largest_collective"] = max(
            [n for _, n in sizes], default=0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", type=int, default=None, choices=(4,),
                    help="run only the multi-device phase on this many "
                    "devices")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pulseportraiture_tpu.utils import card_report, use_compile_cache

    use_compile_cache()
    print(card_report(), flush=True)
    print(f"jax {jax.__version__}: {len(jax.devices())} x "
          f"{dev.device_kind}", flush=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    if args.mesh:
        phases = [("mesh", lambda: phase_mesh(args.mesh, seed=args.seed,
                                              work=work))]
    else:
        phases = [
            ("setup_parity", lambda: phase_setup_parity(seed=args.seed)),
            ("noiseless_fit", lambda: phase_noiseless_fit(seed=args.seed)),
            ("campaign", lambda: phase_campaign(seed=args.seed,
                                                work=work))]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            info = fn()
        except Exception:
            traceback.print_exc()
            print(f"phase {name}: FAILED after "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            return 1
        print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
              f"{json.dumps(info)}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
