"""Platform plumbing: the CPU backend that LSH banks are pinned to, the
``jax_platforms`` widening, the compile-cache location, the exact top-L
selection, and the ground-truth path."""

import inspect
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, **env) -> subprocess.CompletedProcess:
    full = {k: v for k, v in os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS",
                         "JAX_COMPILATION_CACHE_DIR")}
    full.update(env)
    full["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-c", code], env=full, cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_cpu_device_is_a_cpu_device():
    from fspann.ops import coding

    assert coding._cpu_device().platform == "cpu"


def test_cpu_device_raises_without_cpu_backend():
    # config strings only: the platform list is narrowed after import, so
    # no CPU backend can resolve — the bank build must refuse, not fall back
    p = _run("import jax, fspann\n"
             "from fspann.ops import coding\n"
             "jax.config.update('jax_platforms', 'cuda')\n"
             "try:\n"
             "    coding._cpu_device()\n"
             "except RuntimeError as e:\n"
             "    print('RAISED', e)\n")
    assert "RAISED no CPU backend" in p.stdout, p.stderr[-2000:]


def test_explicit_platform_list_gains_cpu():
    p = _run("import fspann, jax\n"
             "print('PLATFORMS', jax.config.jax_platforms)\n",
             JAX_PLATFORMS="cuda")
    assert "PLATFORMS cuda,cpu" in p.stdout, p.stderr[-2000:]


def test_cpu_platform_list_unchanged():
    p = _run("import fspann, jax\n"
             "print('PLATFORMS', jax.config.jax_platforms)\n",
             JAX_PLATFORMS="cpu")
    assert "PLATFORMS cpu\n" in p.stdout, p.stderr[-2000:]


@pytest.mark.parametrize("chunked", [False, True])
def test_approx_and_exact_selection_agree(rng, chunked):
    """XLA:CPU lowers approx_max_k to an exact top-k, as XLA:GPU does: both
    selections give identical scores, and exact is the default."""
    import jax.numpy as jnp
    from fspann.ops import hamming_scan

    codes = rng.integers(0, 2**32, size=(3000, 6, 2), dtype=np.uint32)
    qc = rng.integers(0, 2**32, size=(16, 6, 2), dtype=np.uint32)
    state = hamming_scan.build_scan_state(codes, 64)
    qbits = jnp.asarray(hamming_scan.unpack_bits_numpy(qc, 64))
    tomb = jnp.zeros(len(codes), bool).at[::7].set(True)
    fn = hamming_scan.scan_chunked if chunked else hamming_scan.scan
    kw = {"chunk": 1024} if chunked else {}
    a = fn(state, qbits, tomb, 200, approx=True, **kw)
    e = fn(state, qbits, tomb, 200, approx=False, **kw)
    d = fn(state, qbits, tomb, 200, **kw)
    np.testing.assert_array_equal(np.asarray(a.scores), np.asarray(e.scores))
    np.testing.assert_array_equal(np.asarray(d.ids), np.asarray(e.ids))
    assert inspect.signature(fn).parameters["approx"].default is False


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from fspann.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_compile_cache_defaults_to_repo(monkeypatch):
    from fspann.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_enable_compile_cache_sets_no_other_dir(tmp_path):
    p = _run("import jax\n"
             "from fspann.utils.compile_cache import enable_compile_cache\n"
             "d = enable_compile_cache()\n"
             "print('DIR', d, jax.config.jax_compilation_cache_dir)\n",
             JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert f"DIR {tmp_path} {tmp_path}" in p.stdout, p.stderr[-2000:]


def test_groundtruth_has_no_pallas_route():
    from fspann.io import groundtruth

    assert "backend" not in inspect.signature(
        groundtruth.precompute).parameters
    assert importlib.util.find_spec("fspann.ops.pallas_topk") is None


def test_groundtruth_precompute_is_exact(rng):
    from fspann.io import groundtruth

    base = rng.normal(size=(700, 12)).astype(np.float32)
    qs = rng.normal(size=(9, 12)).astype(np.float32)
    gtm = groundtruth.precompute(base, qs, k=5, chunk=256)
    d2 = ((qs[:, None, :] - base[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(gtm.gt, np.argsort(d2, axis=1)[:, :5])
