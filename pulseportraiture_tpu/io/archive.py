"""load_data / unload / write_archive: the archive-access API.

load_data returns a DataBunch with the same schema as the reference's
PSRCHIVE-backed loader (pplib.py:2650-2814) so everything above L0 is
drop-in: subints, freqs, weights, masks, noise_stds, SNRs, epochs, Ps,
doppler_factors, ok_isubs/ok_ichans, profile stats, and header metadata.
"""

from __future__ import annotations

import numpy as np

from pulseportraiture_tpu.io.mjd import MJD
from pulseportraiture_tpu.io.psrfits import Archive, read_psrfits, \
    write_psrfits
from pulseportraiture_tpu.io.telescopes import telescope_code
from pulseportraiture_tpu.utils import DataBunch, get_bin_centers


def _tune_allocator():
    """Keep glibc from mmap/munmap-cycling NumPy's large buffers.

    Campaign loads allocate ~10 multi-10-MB arrays per archive; above
    glibc's default mmap threshold each is mapped and unmapped per call,
    so every archive re-pays soft page faults on first touch.  Raising
    the threshold keeps the blocks on the heap
    for reuse.  Gated by PP_MALLOPT=0; silently skipped off glibc.
    """
    import os
    if os.environ.get("PP_MALLOPT", "1") in ("0", "false"):
        return
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_MMAP_THRESHOLD = -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
    except Exception:
        pass


_tune_allocator()


def _ephemeris_geometry(arch, nsub):
    """Per-subint (doppler_factors, parallactic_angles).

    Mirrors reference pplib.py:2696-2707: PSRCHIVE's per-Integration
    get_doppler_factor()/get_parallactic_angle() are recomputed from the
    stored ephemeris (RAJ/DECJ) and the observatory coordinates.  A file
    DOPPLER column overrides the Doppler computation; unknown sites or
    missing coordinates fall back to df=1, pa=0.
    """
    dfs = arch.doppler_factors
    pas = np.zeros(nsub)
    ra_deg = dec_deg = None
    if arch.ephemeris_lines:
        from pulseportraiture_tpu.io.par import parse_par
        from pulseportraiture_tpu.io.parang import dms_to_deg, hms_to_deg
        par = parse_par(arch.ephemeris_lines)
        if hasattr(par, "RAJ") and hasattr(par, "DECJ"):
            try:
                ra_deg = hms_to_deg(par.RAJ)
                dec_deg = dms_to_deg(par.DECJ)
            except ValueError:
                pass
    if ra_deg is None:
        return (dfs if dfs is not None else np.ones(nsub)), pas
    from pulseportraiture_tpu.io.ephem import doppler_factor
    from pulseportraiture_tpu.io.parang import (OBSERVATORY_COORDS,
                                                parallactic_angle)
    coords = OBSERVATORY_COORDS.get(str(arch.telescope).upper())
    lat, lon = coords if coords is not None else (None, None)
    mjds = np.array([e.in_days() for e in arch.epochs])
    if dfs is None:
        dfs = np.asarray(doppler_factor(mjds, ra_deg, dec_deg, lat, lon))
    if coords is not None and hasattr(par, "RAJ"):
        pas = np.array([parallactic_angle(arch.telescope, par.RAJ,
                                          par.DECJ, m) for m in mjds])
    return dfs, pas


def load_data(filename, state=None, dedisperse=False, dededisperse=False,
              tscrunch=False, pscrunch=False, fscrunch=False,
              rm_baseline=True, flux_prof=False, refresh_arch=True,
              return_arch=True, quiet=True):
    """Load an archive file into the universal DataBunch record.

    Schema-parity with reference pplib.py:2650-2814.
    """
    from pulseportraiture_tpu.ops.noise import get_noise_PS, get_SNR

    arch = read_psrfits(filename)
    source = arch.source
    telescope = arch.telescope
    tcode = telescope_code(telescope)
    frontend, backend = arch.frontend, arch.backend
    backend_delay = arch.backend_delay
    # int16-native ingest bookkeeping: raw_i2/raw_scl mirror the FILE
    # samples.  remove_baseline only shifts per-channel offsets (DC-only
    # under F0_FACT zeroing, psrfits.Archive docstring) so it keeps them
    # valid; any transform that actually rewrites the sample values
    # invalidates them.
    raw_ok = arch.raw_i2 is not None and arch.npol == 1
    if state is not None and state != arch.state and state == "Intensity":
        raw_ok = raw_ok and arch.npol == 1
        arch.pscrunch()
    if dedisperse:
        raw_ok = raw_ok and (arch.dedispersed or arch.DM == 0.0)
        arch.dedisperse()
    if dededisperse:
        raw_ok = raw_ok and (not arch.dedispersed or arch.DM == 0.0)
        arch.dededisperse()
    DM = arch.DM
    dmc = arch.dedispersed
    if state is not None and state != arch.state:
        raw_ok = raw_ok and arch.npol == 1
        arch.convert_state(state)
    if rm_baseline:
        arch.remove_baseline()
    if tscrunch:
        raw_ok = False
        arch.tscrunch()
    if pscrunch:
        raw_ok = raw_ok and arch.npol == 1
        arch.pscrunch()
    if fscrunch:
        raw_ok = False
        arch.fscrunch()
    nsub, npol, nchan, nbin = arch.data.shape
    integration_length = float(arch.subtimes.sum())
    # Doppler factors & parallactic angles: the reference computes both
    # per subint from ephemeris + site via PSRCHIVE (pplib.py:2696-2707).
    # A file DOPPLER column (written by this framework's own archives)
    # overrides the analytic computation.
    doppler_factors, parallactic_angles = _ephemeris_geometry(arch, nsub)
    nu0 = arch.nu0
    bw = arch.bw
    freqs = np.asarray(arch.freqs, dtype=np.float64)
    if freqs.shape[0] != nsub:
        freqs = np.broadcast_to(freqs[:1], (nsub, nchan)).copy()
    phases = get_bin_centers(nbin, lo=0.0, hi=1.0)
    # dtype-preserving: i2/f4 archives flow through as f32 (the upcast
    # to f64 added no information and doubled every host pass on
    # campaign loads); f8 archives and dedispersed cubes (the host
    # rotation is f64) keep f64
    subints = np.asarray(arch.data)
    Ps = np.asarray(arch.Ps, dtype=np.float64)
    epochs = list(arch.epochs)
    subtimes = list(np.asarray(arch.subtimes, dtype=np.float64))
    weights = np.asarray(arch.weights, dtype=np.float64)
    weights_norm = np.where(weights == 0.0, 0.0, 1.0)
    # per-(sub, pol, chan) off-pulse noise via the PS estimator.  The
    # estimate is an error bar (relative accuracy ~1/sqrt(nbin/8)), so
    # the FFTs run in float32 — half the host cost of the f64 path on
    # campaign loads — and the result is carried as f64 for dtype
    # stability downstream.
    subints_f32 = np.asarray(arch.data, dtype=np.float32)
    noise_stds = np.asarray(get_noise_PS(subints_f32, chans=True),
                            dtype=np.float64)
    ok_isubs = np.compress(weights_norm.mean(axis=1), range(nsub))
    ok_ichans = [np.compress(weights_norm[isub], range(nchan))
                 for isub in range(nsub)]
    nz = noise_stds[noise_stds > 0.0]
    SNRs = np.asarray(
        get_SNR(subints_f32,
                noise=np.float32(np.sqrt(np.mean(nz ** 2)) if nz.size
                                 else 1.0)),
        dtype=np.float64)
    if flux_prof:
        fl = arch.copy()
        fl.pscrunch()
        fl.dedisperse()
        fl.tscrunch()
        flux_prof_arr = fl.data.mean(axis=3)[0][0]
    else:
        flux_prof_arr = np.array([])
    if not quiet:
        print(f"Read {filename}: {source} P={Ps[0] * 1000:.3f} ms "
              f"DM={DM:.6f} {nchan}x{nbin} nsub={nsub} state={arch.state}")
    data = DataBunch(
        arch=arch if return_arch else None, backend=backend,
        backend_delay=backend_delay, bw=bw,
        doppler_factors=doppler_factors, DM=DM, dmc=dmc, epochs=epochs,
        filename=filename, flux_prof=flux_prof_arr, freqs=freqs,
        frontend=frontend, integration_length=integration_length,
        nbin=nbin, nchan=nchan, noise_stds=noise_stds,
        npol=npol, nsub=nsub, nu0=nu0, ok_ichans=ok_ichans,
        ok_isubs=ok_isubs, parallactic_angles=parallactic_angles,
        phases=phases,
        Ps=Ps, SNRs=SNRs, source=source, state=arch.state, subints=subints,
        subtimes=subtimes, telescope=telescope, telescope_code=tcode,
        weights=weights)
    if raw_ok:
        # int16-native ingest: (nsub, nchan, nbin) i2 + (nsub, nchan)
        # scales, equal to subints up to per-channel offsets (DC-only).
        # GetTOAs uploads these instead of f32 ports — half the bytes
        # over the wire and half the setup kernel's HBM read.
        data.raw_i2 = arch.raw_i2[:, 0]
        data.raw_scl = arch.raw_scl[:, 0].astype(np.float32)

    # diagnostic fields the TOA pipeline never touches are lazy: masks
    # is an (nsub, npol, nchan, nbin) broadcast and the profile stats
    # cost a full-archive copy + f64 dedispersion FFT — they
    # materialize (cached) on first attribute access (DataPortrait /
    # ppgauss use them; GetTOAs over a 1000-epoch campaign must not
    # pay for them per archive)
    def _masks():
        m = np.einsum("ij,k->ijk", weights_norm, np.ones(nbin))
        return np.einsum("j,ikl->ijkl", np.ones(npol), m)

    def _prof_arch():
        pa = arch.copy()
        pa.pscrunch()
        pa.dedisperse()
        pa.tscrunch()
        pa.fscrunch()
        return pa.data[0, 0, 0]

    data.add_lazy("masks", _masks)
    data.add_lazy("prof", _prof_arch)
    data.add_lazy("prof_noise", lambda: float(get_noise_PS(data.prof)))
    data.add_lazy("prof_SNR", lambda: float(get_SNR(data.prof)))
    return data


def unload_new_archive(data, arch: Archive, outfile, DM=None, dmc=0,
                       weights=None, quiet=False):
    """Write new amplitudes into a copy of arch and unload it.

    Reference: pplib.py:3033-3069.
    """
    out = arch.copy()
    if dmc:
        out.dedisperse()
    else:
        out.dededisperse()
    if DM is not None:
        out.DM = float(DM)
    out.data = np.asarray(data, dtype=np.float64)
    if weights is not None:
        out.weights = np.asarray(weights, dtype=np.float64)
    write_psrfits(outfile, out, quiet=quiet)


def write_archive(data, ephemeris, freqs, nu0=None, bw=None,
                  outfile="pparchive.fits", tsub=1.0, start_MJD=None,
                  weights=None, dedispersed=False, state="Stokes",
                  telescope="GBT", quiet=False):
    """Write a data cube + ephemeris to a new archive.

    Reference: pplib.py:3071-3181 (PSRCHIVE ASP-archive hack replaced by
    direct PSRFITS-subset writing).  Takes dedispersed data.
    """
    from pulseportraiture_tpu.io.par import parse_par, period_at

    data = np.asarray(data, dtype=np.float64)
    nsub, npol, nchan, nbin = data.shape
    freqs = np.asarray(freqs, dtype=np.float64)
    if nu0 is None:
        nu0 = freqs.mean()
    if bw is None:
        bw = (freqs.max() - freqs.min()) + abs(freqs[1] - freqs[0])
    if isinstance(ephemeris, str):
        with open(ephemeris) as f:
            eph_lines = f.readlines()
    else:
        eph_lines = list(ephemeris)
    par = parse_par(eph_lines)
    if start_MJD is None:
        start_MJD = MJD(50000, 0, 0.0)
    epochs = [start_MJD.add_seconds(tsub / 2.0 + i * tsub)
              for i in range(nsub)]
    Ps = np.array([period_at(par, ep.in_days()) for ep in epochs])
    if weights is None:
        weights = np.ones((nsub, nchan))
    arch = Archive(
        data=data, freqs=np.broadcast_to(freqs, (nsub, nchan)).copy(),
        weights=np.asarray(weights, dtype=np.float64), Ps=Ps, epochs=epochs,
        subtimes=np.full(nsub, float(tsub)), DM=par.DM,
        dedispersed=True, nu0=float(nu0), bw=float(bw), source=par.PSR,
        telescope=telescope, frontend="fake_rx", backend="fake_be",
        state=state if npol == 4 else "Intensity",
        ephemeris_lines=[ln.rstrip("\n") for ln in eph_lines])
    if not dedispersed:
        arch.dededisperse()
    write_psrfits(outfile, arch, quiet=quiet)
    return arch
