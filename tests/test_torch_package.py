"""The port stands alone (no JAX, nothing of librosa_tpu) and puts arrays where it says."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import librosa_tpu_torch as L

ROOT = Path(__file__).resolve().parent.parent


def test_import_pulls_in_no_jax():
    code = (
        "import sys, librosa_tpu_torch, librosa_tpu_torch.entry\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'librosa_tpu' or m.startswith('librosa_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_the_alignment_and_effects_modules_pull_in_no_jax():
    code = (
        "import sys\n"
        "import librosa_tpu_torch.segment, librosa_tpu_torch.ops.knn\n"
        "import librosa_tpu_torch.effects, librosa_tpu_torch.decompose\n"
        "import librosa_tpu_torch.sequence, librosa_tpu_torch.core.notation\n"
        "import librosa_tpu_torch.util._nnls, librosa_tpu_torch.feature.utils\n"
        "import librosa_tpu_torch.feature.inverse, librosa_tpu_torch.ops.spline\n"
        "import librosa_tpu_torch.core.spectrum_ext\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'librosa_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_the_structure_and_infrastructure_modules_pull_in_no_jax():
    code = (
        "import sys\n"
        "import librosa_tpu_torch as L, librosa_tpu_torch._cache, librosa_tpu_torch.display\n"
        "import librosa_tpu_torch.util.profiling, librosa_tpu_torch.ops.ctfft\n"
        "import librosa_tpu_torch.ops.fft, librosa_tpu_torch.ops.transforms\n"
        "assert L.display is librosa_tpu_torch.display and callable(L.segment.path_enhance)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'librosa_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_the_parallel_modules_pull_in_no_jax():
    code = (
        "import sys\n"
        "import librosa_tpu_torch as L, librosa_tpu_torch.entry\n"
        "import librosa_tpu_torch.parallel.mesh, librosa_tpu_torch.parallel.collectives\n"
        "import librosa_tpu_torch.parallel.sharded, librosa_tpu_torch.parallel.analysis\n"
        "import librosa_tpu_torch.parallel.constantq, librosa_tpu_torch.parallel.effects\n"
        "import librosa_tpu_torch.parallel.scaling\n"
        "assert L.parallel is librosa_tpu_torch.parallel\n"
        "assert callable(librosa_tpu_torch.entry.dryrun_multichip)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'librosa_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_meshes_try_the_card_by_default(monkeypatch):
    """With the cuda default and no card, the default meshes raise instead of laying
    positions on the CPU; positions given explicitly keep their device."""
    from librosa_tpu_torch import parallel as P

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = L.get_device()
    L.set_device("cuda")
    try:
        for call in (P.time_mesh, lambda: P.make_mesh((1,), ("time",)),
                     lambda: P.pod_mesh(track_axis=1)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
        mesh = P.time_mesh(devices=["cpu"] * 2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.stft_sharded(np.zeros(2 * 4096, dtype=np.float32), mesh=mesh)
        out = P.stft_sharded(torch.zeros(2 * 4096), mesh=mesh)
        assert out.device.type == "cpu"
    finally:
        L.set_device(prev)


def test_import_and_mfcc_need_no_matplotlib_sklearn_or_joblib():
    """With the three blocked, the package imports, imports none of them, and computes an mfcc."""
    code = (
        "import sys\n"
        "for name in ('matplotlib', 'sklearn', 'joblib'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, librosa_tpu_torch as L\n"
        "L.set_device('cpu')\n"
        "M = L.feature.mfcc(y=np.random.RandomState(0).randn(4096).astype(np.float32), sr=22050)\n"
        "assert tuple(M.shape) == (20, 9), M.shape\n"
        "assert L.filters.mel(sr=22050, n_fft=512).shape == (128, 257)\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                ('matplotlib', 'sklearn', 'joblib') and sys.modules[m] is not None)\n"
        "assert not loaded, loaded\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_path_enhance_ctfft_and_calibrate_try_the_card_by_default(monkeypatch):
    """Without set_device('cpu') each puts its array on cuda and fails here."""
    from librosa_tpu_torch.ops import ctfft
    from librosa_tpu_torch.util import profiling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = L.get_device()
    L.set_device("cuda")
    R = np.random.RandomState(0).rand(20, 20)
    x = np.ones(1000, dtype=np.complex64)
    try:
        for call in (lambda: L.segment.path_enhance(R, 5), lambda: ctfft.fft_arbitrary(x, 1000),
                     lambda: profiling.calibrate(size=16, chain=1)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
        # a CPU tensor keeps its device
        assert L.segment.path_enhance(torch.from_numpy(R), 5).device.type == "cpu"
        assert ctfft.fft_arbitrary(torch.from_numpy(x), 1000).device.type == "cpu"
    finally:
        L.set_device(prev)


def test_alignment_and_effects_try_the_card_by_default(monkeypatch):
    """Without set_device('cpu') the search, the phase vocoder and the stretch go to cuda and fail here."""
    from librosa_tpu_torch.ops import knn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = L.get_device()
    L.set_device("cuda")
    try:
        X = np.random.RandomState(0).rand(30, 4)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            knn.topm(X, X, 3)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            L.segment.recurrence_matrix(X.T)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            L.phase_vocoder(np.ones((5, 8), dtype=np.complex64), rate=2.0)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            L.effects.time_stretch(np.zeros(4096, dtype=np.float32), rate=2.0)
        # a CPU tensor keeps its device
        assert L.phase_vocoder(torch.ones(5, 8, dtype=torch.complex64), rate=2.0).device.type == "cpu"
        assert knn.topm(torch.from_numpy(X), X, 3)[1].shape == (30, 3)
    finally:
        L.set_device(prev)


def test_inversion_pcen_and_spectral_extensions_try_the_card_by_default(monkeypatch):
    """Without set_device('cpu') each entry point puts its array on cuda and fails here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = L.get_device()
    L.set_device("cuda")
    y = np.random.RandomState(0).randn(4096).astype(np.float32)
    S = np.abs(np.random.RandomState(1).randn(257, 20)).astype(np.float32)
    calls = [lambda: L.util.nnls(np.ones((4, 6), np.float32), np.ones((4, 3), np.float32)),
             lambda: L.feature.inverse.mel_to_stft(np.ones((32, 5), np.float32), n_fft=512,
                                                   n_mels=32),
             lambda: L.feature.spectral_contrast(S=S),
             lambda: L.feature.delta(S),
             lambda: L.pcen(S),
             lambda: L.iirt(y, res_type="polyphase"),
             lambda: L.reassigned_spectrogram(y, n_fft=512),
             lambda: L.fmt(y)]
    try:
        for call in calls:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
        # a CPU tensor keeps its device
        assert L.pcen(torch.from_numpy(S)).device.type == "cpu"
        assert L.fmt(torch.from_numpy(y[:256])).device.type == "cpu"
    finally:
        L.set_device(prev)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "librosa_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {"librosa_tpu_torch/io/_soxr.py", "librosa_tpu_torch/core/audio.py",
            "librosa_tpu_torch/core/pitch.py", "librosa_tpu_torch/ops/ola_norm.py",
            "librosa_tpu_torch/io/_native.py", "librosa_tpu_torch/util/files.py",
            "librosa_tpu_torch/beat.py", "librosa_tpu_torch/ops/viterbi.py",
            "librosa_tpu_torch/segment.py", "librosa_tpu_torch/ops/knn.py",
            "librosa_tpu_torch/util/_nnls.py", "librosa_tpu_torch/feature/utils.py",
            "librosa_tpu_torch/feature/inverse.py", "librosa_tpu_torch/ops/spline.py",
            "librosa_tpu_torch/core/spectrum_ext.py", "librosa_tpu_torch/_cache.py",
            "librosa_tpu_torch/display.py", "librosa_tpu_torch/util/profiling.py",
            "librosa_tpu_torch/ops/ctfft.py", "librosa_tpu_torch/ops/fft.py",
            "librosa_tpu_torch/parallel/mesh.py", "librosa_tpu_torch/parallel/collectives.py",
            "librosa_tpu_torch/parallel/sharded.py", "librosa_tpu_torch/parallel/analysis.py",
            "librosa_tpu_torch/parallel/constantq.py", "librosa_tpu_torch/parallel/effects.py",
            "librosa_tpu_torch/parallel/scaling.py"} <= names
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "librosa_tpu"), (path, mod)


def test_numpy_input_with_cuda_default_and_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = L.get_device()
    L.set_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            L.feature.melspectrogram(y=np.zeros(4096, dtype=np.float32), sr=22050)
        with pytest.raises(RuntimeError, match="set_device"):
            L.power_to_db(np.ones((4, 4), dtype=np.float32))
        # a tensor stays on the device its caller chose
        M = L.feature.melspectrogram(y=torch.zeros(4096), sr=22050)
        assert M.device.type == "cpu"
    finally:
        L.set_device(prev)


def test_default_device_is_cuda_and_settable():
    prev = L.get_device()
    try:
        L.set_device("cuda")
        assert L.get_device() == torch.device("cuda")
        L.set_device("cpu")
        out = L.power_to_db(np.ones((2, 3), dtype=np.float32))
        assert out.device.type == "cpu"
    finally:
        L.set_device(prev)


def test_namespace_layout():
    for name in ("melspectrogram", "mfcc", "chroma_stft", "spectral_centroid",
                 "spectral_rolloff", "rms"):
        assert callable(getattr(L.feature, name))
    for name in ("mel", "chroma", "get_window", "window_sumsquare", "cq_to_chroma",
                 "diagonal_filter"):
        assert callable(getattr(L.filters, name))
    for name in ("power_to_db", "hz_to_mel", "mel_to_hz", "fft_frequencies",
                 "mel_frequencies", "set_device", "get_device", "stft", "magphase",
                 "amplitude_to_db", "db_to_power", "db_to_amplitude", "perceptual_weighting",
                 "frequency_weighting", "A_weighting", "B_weighting", "C_weighting",
                 "D_weighting", "Z_weighting", "istft", "griffinlim", "resample", "piptrack",
                 "pitch_tuning", "estimate_tuning", "tone", "chirp", "clicks", "hz_to_octs",
                 "octs_to_hz"):
        assert callable(getattr(L, name))
    for name in ("tiny", "expand_to", "normalize", "pad_center", "fix_length", "localmax",
                 "localmin", "dtype_r2c", "dtype_c2r", "abs2", "phasor"):
        assert callable(getattr(L.util, name))
    import librosa_tpu_torch.core.audio
    import librosa_tpu_torch.core.pitch
    import librosa_tpu_torch.io._soxr
    import librosa_tpu_torch.ops.ola_norm
    assert L.core.audio.resample is L.resample and L.core.pitch.piptrack is L.piptrack
    assert callable(L.io._soxr.available) and callable(L.ops.ola_norm.ola_norm)
    from librosa_tpu_torch import entry
    assert callable(entry.entry) and callable(entry.feature_stack)
    assert callable(entry.reconstruction)
    assert issubclass(L.ParameterError, L.LibrosaError)


def test_util_helpers():
    assert L.util.tiny(torch.zeros(2, dtype=torch.float64)) == np.finfo(np.float64).tiny
    assert L.util.tiny(np.zeros(2, dtype=np.int32)) == np.finfo(np.float32).tiny
    assert L.util.expand_to(torch.ones(3), ndim=3, axes=1).shape == (1, 3, 1)
    with pytest.raises(L.ParameterError):
        L.util.expand_to(torch.ones(3, 2), ndim=3, axes=1)


def test_decoding_maps_no_file_of_the_jax_package(tmp_path):
    """After ``read_audio`` and ``load``, no file under librosa_tpu/ is mapped into the process.

    The decoder that is mapped is the port's own, built under
    ``librosa_tpu_torch/_build/``; the JAX package's tracked library is never loaded.
    """
    import os
    import wave

    from flac_writer import write_flac

    pcm = (np.random.RandomState(0).randn(4000, 2) * 3000).astype("<i2")
    wav, flac = tmp_path / "a.wav", tmp_path / "a.flac"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    write_flac(str(flac), pcm, 16000)
    code = (
        "import sys, librosa_tpu_torch as L\n"
        "from librosa_tpu_torch.io import _native\n"
        "L.set_device('cpu')\n"
        f"y, sr = L.io.read_audio({str(flac)!r})\n"
        "assert y.shape == (2, 4000) and sr == 16000\n"
        f"y, sr = L.load({str(wav)!r}, sr=None)\n"
        "assert y.shape == (4000,)\n"
        "paths = {line.split()[-1] for line in open('/proc/self/maps') if '/' in line}\n"
        f"bad = sorted(p for p in paths if p.startswith({str(ROOT / 'librosa_tpu')!r} + '/'))\n"
        "assert not bad, bad\n"
        "lib = str(_native.library_path())\n"
        "assert lib in paths, (lib, sorted(p for p in paths if 'audioio' in p))\n"
        f"assert lib.startswith({str(ROOT / 'librosa_tpu_torch' / '_build')!r} + '/'), lib\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'librosa_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr


def test_beat_tracking_maps_no_file_of_the_jax_package():
    """After ``beat_track`` on one envelope, the port's own host DP is mapped and nothing of librosa_tpu/."""
    import os

    code = (
        "import sys, numpy as np, librosa_tpu_torch as L\n"
        "from librosa_tpu_torch.ops import _build\n"
        "L.set_device('cpu')\n"
        "env = np.zeros(400, dtype=np.float32); env[::22] = 1.0\n"
        "tempo, beats = L.beat.beat_track(onset_envelope=env, sr=22050)\n"
        "assert len(beats) > 5, beats\n"
        "paths = {line.split()[-1] for line in open('/proc/self/maps') if '/' in line}\n"
        f"bad = sorted(p for p in paths if p.startswith({str(ROOT / 'librosa_tpu')!r} + '/'))\n"
        "assert not bad, bad\n"
        "lib = str(_build._lib_path('hostdp'))\n"
        "assert lib in paths, (lib, sorted(p for p in paths if 'hostdp' in p))\n"
        f"assert lib.startswith({str(ROOT / 'librosa_tpu_torch' / '_build')!r} + '/'), lib\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'librosa_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
