"""Mesh construction and sharded batched fitting.

The workload's parallel axes (SURVEY.md section 2): *batch* =
epochs x subints (embarrassingly parallel TOA fits, the data-parallel
axis) and *channel* (the per-channel Cdbp/Sbp sufficient statistics are
channel-separable sums, so the channel axis shards like a sequence axis —
each device reduces its channels' partial C/S/gradient/Hessian and a
single small psum closes the Newton step).

Two routes.  fit_portrait_full_sharded builds the full-band setup per
shard under shard_map (the rFFT cross-spectrum is channel-local) and
runs the Newton loop under GSPMD, which inserts the cross-device
reductions over 'chan' (1 + 5 + 25 floats per item per iteration).
fit_portrait_full_sharded_direct runs the capped direct-DFT setup, plain
XLA, with the whole fit in one GSPMD jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_batch=None, n_chan=1, devices=None) -> Mesh:
    """Build a ('batch', 'chan') mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    total = len(devices)
    if n_batch is None:
        n_batch = total // n_chan
    assert n_batch * n_chan <= total, \
        f"mesh {n_batch}x{n_chan} exceeds {total} devices"
    grid = np.array(devices[:n_batch * n_chan]).reshape(n_batch, n_chan)
    return Mesh(grid, ("batch", "chan"))


def shard_fit_inputs(mesh, data_ports, model_ports, init_params, Ps, freqs,
                     errs, weights=None, nu_fits=None):
    """device_put the batched-fit operands with ('batch','chan') layouts.

    model_ports may be (nchan, nbin) — the shared-model fast path — in
    which case it shards as ('chan', None) and replicates over 'batch'.
    Returns the sharded operands in fit_portrait_full_batch order.
    """
    B, nchan, _ = data_ports.shape
    if freqs.ndim == 1:
        freqs = jnp.broadcast_to(freqs, (B, nchan))
    if weights is None:
        weights = jnp.ones_like(errs)
    if nu_fits is None:
        nu_fits = jnp.broadcast_to(freqs.mean(axis=-1)[:, None], (B, 3))

    s_port = NamedSharding(mesh, P("batch", "chan", None))
    s_model = s_port if model_ports.ndim == 3 else \
        NamedSharding(mesh, P("chan", None))
    s_chan = NamedSharding(mesh, P("batch", "chan"))
    s_item = NamedSharding(mesh, P("batch"))

    return (jax.device_put(data_ports, s_port),
            jax.device_put(model_ports, s_model),
            jax.device_put(init_params, s_item),
            jax.device_put(Ps, s_item),
            jax.device_put(freqs, s_chan),
            jax.device_put(errs, s_chan),
            jax.device_put(weights, s_chan),
            jax.device_put(nu_fits, s_item))


def fit_portrait_full_sharded(mesh, data_ports, model_ports, init_params,
                              Ps, freqs, errs, weights=None,
                              nu_fits=None, fit_flags=(1, 1, 0, 0, 0),
                              log10_tau=True, max_iter=100, scattering=None,
                              seed_phase=False, scales=None,
                              model_ft_ri=None, packed=False):
    """Batched wideband fit with (batch, chan)-sharded portraits.

    data_ports: (B, nchan, nbin), float or int16 with per-channel
    dequantization `scales` (B, nchan); model_ports: (B, nchan, nbin)
    or the shared (nchan, nbin) template; model_ft_ri: optional shared
    natural-order model spectrum (re, im), each (nchan, nharm).

    The setup (rFFT cross-spectrum, per-channel data power) runs per
    shard under shard_map: it is channel-local, so no portrait or
    spectrum crosses devices.  seed_phase=True closes the seed's
    weighted band sums with one (B, nharm) psum over 'chan' and seeds
    the phase from them (fitters.portrait._brute_phase_seed).  The
    Newton loop then runs under GSPMD (fit_batch_from_setup), whose
    channel reductions lower to all-reduces of per-item scalars.
    packed=True returns pack_result's one (B, K) array.  Otherwise the
    same PortraitFitResult as fit_portrait_full_batch.
    """
    B, nchan, _ = data_ports.shape
    if scales is not None:
        from pulseportraiture_tpu.config import F0_FACT
        assert not F0_FACT, "int16 ingest requires F0_FACT zeroing"
    (data_ports, model_ports, init_params, Ps, freqs, errs, weights,
     nu_fits) = shard_fit_inputs(mesh, data_ports, model_ports,
                                 init_params, Ps, freqs, errs, weights,
                                 nu_fits)
    s_chan = NamedSharding(mesh, P("batch", "chan"))
    s_spec = NamedSharding(mesh, P("chan", None))
    if scales is not None:
        scales = jax.device_put(jnp.asarray(scales, jnp.float32), s_chan)
    if model_ft_ri is not None:
        model_ft_ri = tuple(jax.device_put(jnp.asarray(a), s_spec)
                            for a in model_ft_ri)
    return _sharded_fit(mesh, data_ports, model_ports, init_params, Ps,
                        freqs, errs, weights, nu_fits, scales, model_ft_ri,
                        fit_flags=tuple(int(bool(f)) for f in fit_flags),
                        log10_tau=log10_tau, max_iter=max_iter,
                        scattering=scattering, seed_phase=seed_phase,
                        packed=packed)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "fit_flags", "log10_tau",
                                    "max_iter", "scattering", "seed_phase",
                                    "packed"))
def _sharded_fit(mesh, data_ports, model_ports, init_params, Ps, freqs,
                 errs, weights, nu_fits, scales, model_ft_ri, fit_flags,
                 log10_tau, max_iter, scattering, seed_phase, packed):
    from pulseportraiture_tpu.fitters import stats
    from pulseportraiture_tpu.fitters.portrait import (
        _brute_phase_seed, fit_batch_from_setup, pack_result)

    nbin = data_ports.shape[-1]
    dt = jnp.float32 if scales is not None else data_ports.dtype
    shared = model_ports.ndim == 2
    errs_FT = errs.astype(dt) * jnp.sqrt(jnp.asarray(nbin / 2.0, dt))
    w = jnp.where(errs_FT > 0.0, errs_FT ** -2.0, 0.0) * (weights > 0.0)

    spec_port = P("batch", "chan", None)
    spec_chan = P("batch", "chan")
    spec_model = P("chan", None) if shared else spec_port
    opt = [a for a in (scales, model_ft_ri) if a is not None]

    def local_setup(d, m, wl, *rest):
        rest = list(rest)
        if scales is not None:
            d = d.astype(jnp.float32) * rest.pop(0)[..., None]
        if model_ft_ri is not None:
            mr, mi = (a.astype(dt) for a in rest.pop(0))
        else:
            mr, mi = stats.model_ft(m.astype(dt))
        Gr, Gi, sd = stats.cross_spectrum(d.astype(dt), mr, mi)
        out = (Gr, Gi, sd, mr * mr + mi * mi)
        if seed_phase:
            hi = jax.lax.Precision.HIGHEST
            gsr = jnp.einsum("bc,bck->bk", wl, Gr, precision=hi)
            gsi = jnp.einsum("bc,bck->bk", wl, Gi, precision=hi)
            out += (jax.lax.psum(gsr, "chan"), jax.lax.psum(gsi, "chan"))
        return out

    in_specs = (spec_port, spec_model, spec_chan)
    if scales is not None:
        in_specs += (spec_chan,)
    if model_ft_ri is not None:
        in_specs += ((P("chan", None), P("chan", None)),)
    out_specs = (spec_port, spec_port, spec_chan, spec_model)
    if seed_phase:
        out_specs += (P("batch", None), P("batch", None))
    outs = jax.shard_map(local_setup, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs)(data_ports, model_ports, w,
                                              *opt)
    Gr, Gi, sd, M2 = outs[:4]
    if seed_phase:
        kvec = jnp.arange(Gr.shape[-1], dtype=dt)
        init_params = init_params.at[:, 0].set(
            _brute_phase_seed(outs[4], outs[5], kvec).astype(
                init_params.dtype))
    setup_b = stats.FitSetup(
        Gr=Gr, Gi=Gi, M2=M2, w=w, freqs=freqs.astype(dt),
        P=Ps.astype(dt), nu_DM=nu_fits[:, 0].astype(dt),
        nu_GM=nu_fits[:, 1].astype(dt), nu_tau=nu_fits[:, 2].astype(dt),
        Sd=jnp.sum(w * sd, axis=-1).astype(dt),
        S0=jnp.sum(M2, axis=-1), nbin=int(nbin),
        sd_chan=(w * sd).astype(dt))
    m_ax = None if shared else 0
    axes = stats.FitSetup(Gr=0, Gi=0, M2=m_ax, w=0, freqs=0, P=0,
                          nu_DM=0, nu_GM=0, nu_tau=0, Sd=0, S0=m_ax,
                          nbin=None, kvec=None, sd_chan=0)
    res = fit_batch_from_setup(setup_b, init_params.astype(dt),
                               setup_axes=axes, fit_flags=fit_flags,
                               log10_tau=log10_tau, max_iter=max_iter,
                               scattering=scattering)
    return pack_result(res) if packed else res


def fit_portrait_full_sharded_direct(mesh, data_ports, model_port,
                                     init_params, Ps, freqs, errs,
                                     weights=None, nu_fits=None,
                                     fit_flags=(1, 1, 0, 0, 0),
                                     log10_tau=True, max_iter=100,
                                     scattering=None, dft_precision="high",
                                     seed_phase=False, seed_dm=False,
                                     scales=None,
                                     model_ft_ri=None, mharm=None,
                                     packed=False):
    """Multi-chip capped fit through the direct DFT-matmul setup.

    The capped setup (ops.ct_dft.direct_capped_setup) is plain XLA, so
    one jit over the mesh covers setup + seed + Newton loop with no
    shard_map.  data_ports may be int16 with per-channel `scales`
    (sharded ('batch','chan')): the dequantize is shard-local inside
    the setup matmul's epilogue, so the host->device copies carry half
    the bytes.  packed=True returns pack_result's one (B, K) array; the
    only cross-shard layout work is gathering the (B, nchan)-sized
    channel stats into replicated columns.
    """
    from pulseportraiture_tpu.fitters.portrait import (
        fit_portrait_full_batch, fit_portrait_full_batch_packed)

    assert model_ft_ri is not None and mharm is not None, \
        "the direct sharded path is the capped configuration"
    B, nchan, _ = data_ports.shape
    assert model_port.ndim == 2, "direct sharded path needs one model"
    if freqs.ndim == 1:
        freqs = jnp.broadcast_to(freqs, (B, nchan))
    if weights is None:
        weights = jnp.ones_like(errs)
    if nu_fits is None:
        nu_fits = jnp.broadcast_to(freqs.mean(axis=-1)[:, None], (B, 3))

    s_port = NamedSharding(mesh, P("batch", "chan", None))
    s_spec = NamedSharding(mesh, P("chan", None))
    s_chan = NamedSharding(mesh, P("batch", "chan"))
    s_item = NamedSharding(mesh, P("batch"))
    fn = fit_portrait_full_batch_packed if packed else \
        fit_portrait_full_batch
    return fn(jax.device_put(data_ports, s_port),
              jax.device_put(jnp.asarray(model_port), s_spec),
              jax.device_put(jnp.asarray(init_params), s_item),
              jax.device_put(jnp.asarray(Ps), s_item),
              jax.device_put(jnp.asarray(freqs), s_chan),
              jax.device_put(jnp.asarray(errs), s_chan),
              weights=jax.device_put(jnp.asarray(weights), s_chan),
              nu_fits=jax.device_put(jnp.asarray(nu_fits), s_item),
              fit_flags=fit_flags, log10_tau=log10_tau,
              max_iter=max_iter, scattering=scattering,
              dft_precision=dft_precision,
              ct=True, seed_phase=seed_phase,
              seed_dm=seed_dm,
              scales=None if scales is None else
              jax.device_put(jnp.asarray(scales), s_chan),
              model_ft_ri=(jax.device_put(jnp.asarray(model_ft_ri[0]),
                                          s_spec),
                           jax.device_put(jnp.asarray(model_ft_ri[1]),
                                          s_spec)),
              mharm=mharm)
