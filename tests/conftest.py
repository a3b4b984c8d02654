"""Test configuration: CPU backend with 8 virtual devices (default).

Multi-device sharding paths are tested on a simulated 8-device CPU mesh
(``--xla_force_host_platform_device_count``), per SURVEY.md section 4.
Pallas kernels run in the interpreter there (their tests pass
``interpret=True``).

The suite runs on the CPU unless ``JAX_PLATFORMS`` says otherwise.  The
``gpu``-marked tests (``tests/test_gpu.py``) need the card; they skip
elsewhere, decided at run time by the ``gpu`` fixture.  On a machine with a
GPU::

    JAX_PLATFORMS=cuda python -m pytest -o addopts= -m gpu tests/test_gpu.py
"""

import os
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

# Persistent compilation cache (default ON; disable with
# LQG_TEST_CACHE=0): the suite is compile-dominated, and a warm cache
# makes repeat runs ~3x faster.  This jaxlib build segfaults
# nondeterministically while SERIALIZING MULTI-DEVICE (sharded) executables
# into the cache (observed in compilation_cache.put_executable_and_time and
# once under _compile_and_write_cache during long runs), so the write entry
# point is wrapped below to serialize ONLY single-device executables - the
# large majority of the suite's compiles - and skip sharded ones.  The
# directory is keyed by the jax version: entries serialized by an older
# jaxlib hard-abort (SIGABRT) on load after an upgrade.
if os.environ.get("LQG_TEST_CACHE", "1") != "0":
    _CACHE_NAME = f"jax_lqg_tests-{jax.__version__}"
    for _cache_dir in (os.path.expanduser(f"~/.cache/{_CACHE_NAME}"),
                       os.path.join(tempfile.gettempdir(), _CACHE_NAME)):
        try:
            os.makedirs(_cache_dir, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", _cache_dir)
            jax.config.update("jax_persistent_cache_min_compile_time_secs",
                              0.5)
            break
        except OSError:
            continue

    from jax._src import compilation_cache as _cc

    _orig_put_executable = _cc.put_executable_and_time

    def _put_single_device_only(cache_key, module_name, executable, backend,
                                compile_time):
        """Serialize only single-device executables into the persistent
        cache (sharded-executable serialization segfaults this jaxlib)."""
        try:
            if len(executable.local_devices()) != 1:
                return
        except Exception:
            return
        return _orig_put_executable(cache_key, module_name, executable,
                                    backend, compile_time)

    _cc.put_executable_and_time = _put_single_device_only

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip the test unless JAX's backend is a GPU (decided when the test
    runs, never at collection, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-o addopts= -m gpu tests/test_gpu.py on the card")


@pytest.fixture
def no_compile_cache(monkeypatch):
    """Disable persistent compilation-cache WRITES for a test.

    Serializing MULTI-DEVICE (sharded) executables into the persistent
    cache segfaults in this jaxlib build (SIGSEGV inside
    ``compilation_cache.put_executable_and_time``); sharded tests opt out
    of caching rather than crash the suite.  Neither clearing the cache
    dir nor ``jax_enable_compilation_cache=False`` stops writes once the
    cache object is initialized (verified empirically), so the write entry
    point itself is stubbed out.
    """
    from jax._src import compilation_cache as _cc

    monkeypatch.setattr(_cc, "put_executable_and_time",
                        lambda *a, **k: None)
    yield


@pytest.fixture
def x64():
    """Run a test in float64 for tight oracle comparisons."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)
