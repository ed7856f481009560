"""The port's on-disk cache layer: the cases of tests/test_cache.py on ``librosa_tpu_torch._cache``.

Also: with no directory the manager needs no joblib and its methods match
the JAX package's manager without one; the package's decorated
constructors are the bare functions; and with ``LIBROSA_CACHE_DIR`` set (in
a subprocess, since the module-level manager reads it at import)
``filters.mel`` fills the directory, is served from it, and equals the JAX
package's ``filters.mel`` exactly.
"""

import inspect
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from librosa_tpu._cache import CacheManager as JaxCacheManager
from librosa_tpu_torch._cache import CacheManager

ROOT = Path(__file__).resolve().parent.parent


def _calls_counter():
    state = {"n": 0}

    def f(x):
        state["n"] += 1
        return np.arange(x)

    return f, state


def test_cache_disabled_is_identity():
    cache = CacheManager(None, verbose=0, level=10)
    f, state = _calls_counter()
    assert cache(level=10)(f) is f
    assert cache.memory is None


def test_cache_active_memoizes(tmp_path):
    cache = CacheManager(str(tmp_path), verbose=0, level=10)
    f, state = _calls_counter()
    g = cache(level=10)(f)
    assert g is not f
    r1, r2 = g(5), g(5)
    assert state["n"] == 1
    assert np.array_equal(r1, r2)
    assert len(g(7)) == 7 and state["n"] == 2


def test_cache_level_filter(tmp_path):
    cache = CacheManager(str(tmp_path), verbose=0, level=10)
    f, state = _calls_counter()
    g = cache(level=20)(f)
    assert g is f
    g(3)
    g(3)
    assert state["n"] == 2


def test_cache_clear(tmp_path):
    cache = CacheManager(str(tmp_path), verbose=0, level=10)
    f, state = _calls_counter()
    g = cache(level=10)(f)
    g(4)
    cache.clear(warn=False)
    g(4)
    assert state["n"] == 2


def test_cache_eval_and_reduce_size(tmp_path):
    cache = CacheManager(str(tmp_path), verbose=0, level=10)
    f, state = _calls_counter()
    assert np.array_equal(cache.eval(f, 6), np.arange(6))
    assert np.array_equal(cache.eval(f, 6), np.arange(6))
    assert state["n"] == 1
    cache.reduce_size(items_limit=0)
    cache.eval(f, 6)
    assert state["n"] == 2


def test_methods_without_a_directory_match_the_jax_package(caplog):
    ours, theirs = CacheManager(None, level=10), JaxCacheManager(None, verbose=0, level=10)
    obj = [1, 2, {"a": (3, [4, [5, [6]]])}]
    assert ours.format(obj) == theirs.format(obj)
    assert ours.format(obj, indent=2) == theirs.format(obj, indent=2)
    f, state = _calls_counter()
    assert np.array_equal(ours.eval(f, 3), theirs.eval(f, 3)) and state["n"] == 2
    ours.clear(warn=False)
    ours.reduce_size()
    with caplog.at_level(logging.WARNING):
        ours.warn("hello")
    assert "hello" in caplog.text


def test_library_constructors_are_wrapped(tmp_path):
    import librosa_tpu_torch as L
    from librosa_tpu_torch.core.intervals import plimit_intervals

    for fn in (L.filters.mel, L.filters.chroma, L.filters.diagonal_filter,
               L.filters.window_sumsquare, L.filters.semitone_filterbank,
               L.interval_frequencies, L.pythagorean_intervals, plimit_intervals):
        assert inspect.isfunction(fn), fn  # no directory: the bare function
    M1 = L.filters.mel(sr=22050, n_fft=1024)
    assert np.array_equal(M1, L.filters.mel(sr=22050, n_fft=1024))
    wrapped = CacheManager(str(tmp_path), verbose=0, level=10)(level=10)(plimit_intervals)
    a = wrapped(primes=[3, 5], bins_per_octave=12)
    assert np.array_equal(a, wrapped(primes=[3, 5], bins_per_octave=12))
    assert np.array_equal(a, plimit_intervals(primes=[3, 5], bins_per_octave=12))


def test_mel_is_served_from_the_cache_directory(tmp_path):
    import librosa_tpu as J

    cache_dir, out = tmp_path / "cache", tmp_path / "mel.npy"
    code = (
        "import os, sys, numpy as np\n"
        "import librosa_tpu_torch as L\n"
        "from librosa_tpu_torch import filters\n"
        "d = os.environ['LIBROSA_CACHE_DIR']\n"
        "M1 = L.filters.mel(sr=22050, n_fft=1024, n_mels=64)\n"
        "stored = [f for _, _, fs in os.walk(d) for f in fs]\n"
        "assert stored, 'the first call stored nothing'\n"
        "assert L.filters.mel.check_call_in_cache(sr=22050, n_fft=1024, n_mels=64)\n"
        "def _no_body(*a, **k):\n"
        "    raise AssertionError('the second call ran the function')\n"
        "filters._mel_basis = _no_body\n"
        "M2 = L.filters.mel(sr=22050, n_fft=1024, n_mels=64)\n"
        "assert np.array_equal(M1, M2)\n"
        "assert 'jax' not in sys.modules\n"
        "np.save(sys.argv[1], M1)\n"
    )
    env = dict(os.environ, LIBROSA_CACHE_DIR=str(cache_dir))
    proc = subprocess.run([sys.executable, "-c", code, str(out)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = np.asarray(J.filters.mel(sr=22050, n_fft=1024, n_mels=64))
    got = np.load(out)
    assert got.dtype == want.dtype and np.array_equal(got, want)
