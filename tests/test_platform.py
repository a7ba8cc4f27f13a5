"""
Platform dispatch, the compile-cache helper and the compressed kernel
cache budget, on the CPU with the JAX backend monkeypatched.

Every platform-dependent choice goes through
:func:`slmsuite_tpu.ops.platform.accelerator`. A platform the package has
no path for gets the plain XLA path: no kernel, no assumed memory size.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

PLATFORMS = ["cpu", "gpu", "rocm"]  # rocm: a platform with no path here


@pytest.fixture(params=PLATFORMS)
def platform(request, monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: request.param)
    return request.param


def test_accelerator_names_the_backend(platform):
    from slmsuite_tpu.ops.platform import accelerator

    assert accelerator() == platform


def test_fft_default_per_platform(platform, monkeypatch):
    from slmsuite_tpu.ops import fft as F

    monkeypatch.setattr(F, "_BACKEND", None)
    assert F.get_fft_backend() == F._DEFAULT_BACKEND.get(platform, "xla")
    if platform != "gpu":
        assert F.get_fft_backend() == "xla"


def test_set_fft_backend_retraces_compiled_programs(monkeypatch):
    import jax
    import jax.numpy as jnp

    from slmsuite_tpu.ops import fft as F

    monkeypatch.setattr(F, "_BACKEND", "xla")
    seen = []

    @jax.jit
    def f(x):
        seen.append(F.get_fft_backend())
        return F.fft2(x)

    x = jnp.ones((64, 64), jnp.complex64)
    f(x)
    f(x)
    F.set_fft_backend("matmul")
    f(x)
    F.set_fft_backend("matmul")  # no change: the cache survives
    f(x)
    assert seen == ["xla", "matmul"]


def test_scrambled_gate_per_platform(platform, monkeypatch):
    from slmsuite_tpu.ops import engine as E
    from slmsuite_tpu.ops import fft as F

    monkeypatch.setattr(E, "_SCRAMBLED_MODE", "auto")
    monkeypatch.setattr(F, "_BACKEND", "matmul")
    config = E.GSConfig(method="GS", shape=(64, 64), slm_shape=(64, 64))
    assert E._can_scramble(config) == E._SCRAMBLED_DEFAULT.get(platform, False)
    if platform != "gpu":
        assert not E._can_scramble(config)
    # The scrambled loop needs the four-step tier on every platform.
    monkeypatch.setattr(F, "_BACKEND", "xla")
    assert not E._can_scramble(config)


@pytest.mark.parametrize("cuda", [None, True, False])
@pytest.mark.filterwarnings("ignore::UserWarning")
def test_compressed_path_per_platform(platform, cuda):
    from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
    from slmsuite_tpu.holography.algorithms import CompressedSpotHologram

    slm = SimulatedSLM(resolution=(64, 64), pitch_um=(8, 8), wav_um=0.78)
    spots = np.array([[1e-3, -2e-3, 0.0], [0.0, 1e-3, -1e-3]])
    holo = CompressedSpotHologram(spots, basis="kxy", cameraslm=slm, cuda=cuda)
    holo.flags["method"] = "WGS-Kim"
    on_gpu = platform == "gpu"
    assert holo.cuda == (on_gpu if cuda is None else cuda)
    # The fused kernels run only on a GPU, whatever cuda says.
    assert holo._use_kernels() == (on_gpu and holo.cuda)
    assert holo._compressed_config().use_pallas == holo._use_kernels()


@pytest.mark.parametrize("env", [None, "/some/where/else"])
def test_compile_cache_dir(env, tmp_path, monkeypatch):
    import jax

    from slmsuite_tpu.misc.compile_cache import enable_compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = enable_compile_cache(tmp_path)
        assert path == os.path.join(str(tmp_path), ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert enable_compile_cache(tmp_path) == env
        assert calls == []  # JAX reads the variable itself


class _Device:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize(
    "stats, env, want_mb",
    [
        ({"bytes_limit": 60_000_000_000}, None, 15_000.0),
        ({"bytes_limit": 8_000_000_000}, None, 2_000.0),
        (None, None, 0.0),  # a device that reports no limit: no cache
        ({}, None, 0.0),
        ({"bytes_limit": 60_000_000_000}, "512", 512.0),
        ({"bytes_limit": 60_000_000_000}, "0", 0.0),
    ],
)
def test_cache_budget_from_memory_stats(stats, env, want_mb, monkeypatch):
    import jax

    from slmsuite_tpu.ops import compressed as C

    monkeypatch.setattr(jax, "local_devices", lambda: [_Device(stats)])
    if env is None:
        monkeypatch.delenv("SLMSUITE_TPU_COMPRESSED_CACHE_MB", raising=False)
    else:
        monkeypatch.setenv("SLMSUITE_TPU_COMPRESSED_CACHE_MB", env)
    assert C.cache_budget_mb() == pytest.approx(want_mb)


_BLOCKED_IMPORT = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == {name!r} or name.startswith({name!r} + "."):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
from slmsuite_tpu.holography.algorithms import SpotHologram
import slmsuite_tpu.hardware.cameras.simulated
holo = SpotHologram.make_rectangular_array(
    (64, 64), array_shape=(2, 2), array_pitch=(8, 8), basis="knm"
)
holo.optimize("WGS-Kim", maxiter=3, verbose=True)
assert np.isfinite(holo.phase).all()
assert {name!r} not in sys.modules
print("ok")
"""


@pytest.mark.parametrize("name", ["tqdm", "cv2", "h5py"])
def test_main_path_without_optional_package(name):
    """The package imports and optimizes a SpotHologram with the
    optional package blocked (the progress bar becomes a no-op)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    result = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.format(name=name)],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert result.returncode == 0, result.stderr[-2000:]
    assert result.stdout.strip().endswith("ok")
