"""Device-facing plumbing that the CPU can check: chip_smoke.py's guards
and its parity phases at a small size, the compile-cache rule, and the
fit-chunk sizing from device memory."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    """On the CPU chip_smoke exits non-zero and prints no result line."""
    r = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the repository, chip_smoke cannot pass."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_chip_smoke_setup_parity_small():
    import chip_smoke

    info = chip_smoke.phase_setup_parity(nchan=64, nbin=256)
    assert info["max_rel_err"] < 1e-5


def test_chip_smoke_noiseless_fit_small():
    """The float32 fit phase at 64ch x 256bin, at the card's tolerances."""
    import chip_smoke

    info = chip_smoke.phase_noiseless_fit(nchan=64, nbin=256, B=4)
    assert info["max_dphi"] <= 2e-7 and info["max_dDM"] <= 1e-9
    assert info["tau_sigma"] <= 3.0 and info["alpha_sigma"] <= 3.0


def test_chip_smoke_mesh_small():
    """The --mesh phase on 4 of the virtual CPU devices at 64ch x 1024bin:
    both routes taken, each within 0.01 sigma of one device, and no
    spectra-sized collective.  Two archives: their items share one
    model only if the prefetch workers share the model cache."""
    import jax

    import chip_smoke

    jax.config.update("jax_enable_x64", False)
    try:
        info = chip_smoke.phase_mesh(4, nchan=64, nbin=1024, narch=2,
                                     nsub=2)
    finally:
        jax.config.update("jax_enable_x64", True)
    sig = [v for k, v in info.items() if k.endswith("_sigma")]
    assert len(sig) == 4 and max(sig) <= 0.01


@pytest.fixture
def cache_config():
    import jax

    old = jax.config.jax_compilation_cache_dir
    yield jax
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(cache_config, monkeypatch, tmp_path):
    from pulseportraiture_tpu.utils import use_compile_cache

    jax = cache_config
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_into_checkout(cache_config, monkeypatch):
    from pulseportraiture_tpu.utils import use_compile_cache

    jax = cache_config
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert use_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


class _FakeDevice:
    platform = "gpu"
    device_kind = "fake accelerator"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("limit_gb,want", [(64, 256), (16, 64), (2, 8)])
def test_auto_fit_chunk_from_memory_stats(limit_gb, want, monkeypatch):
    """60% of bytes_limit over ~101 MB/item at 4096ch x 2048bin, rounded
    down to a power of two and capped by PP_FIT_CHUNK."""
    from pulseportraiture_tpu.pipelines.toas import _auto_fit_chunk

    monkeypatch.delenv("PP_FIT_CHUNK", raising=False)
    dev = _FakeDevice({"bytes_limit": limit_gb * 10 ** 9})
    assert _auto_fit_chunk((4096, 2048), dev) == want
    monkeypatch.setenv("PP_FIT_CHUNK", "32")
    assert _auto_fit_chunk((4096, 2048), dev) == min(want, 32)


def test_auto_fit_chunk_needs_memory_stats():
    from pulseportraiture_tpu.pipelines.toas import _auto_fit_chunk

    for stats in (None, {}):
        with pytest.raises(RuntimeError):
            _auto_fit_chunk((4096, 2048), _FakeDevice(stats))


def test_auto_fit_chunk_cpu_and_queue_depth(monkeypatch):
    """The CPU backend sizes from host RAM; two 8.6 GB chunks queue, and
    small chunks queue eight deep."""
    import jax

    from pulseportraiture_tpu.pipelines.toas import (_auto_fit_chunk,
                                                     _depth_for)

    monkeypatch.delenv("PP_FIT_CHUNK", raising=False)
    monkeypatch.delenv("PP_INFLIGHT", raising=False)
    c = _auto_fit_chunk((64, 256), jax.devices("cpu")[0])
    assert 1 <= c <= 256 and c & (c - 1) == 0
    assert _depth_for(256 * 4096 * 2048 * 4) == 2
    assert _depth_for(32 * 128 * 512 * 4) == 8
    assert _depth_for(128 << 20) == 4
