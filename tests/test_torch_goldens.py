"""Golden replay against the PyTorch port (the suites of what it has ported).

The same case table and fixtures as tests/test_goldens.py, which hold the
JAX package to the upstream reference, run here with ``L =
librosa_tpu_torch`` on the CPU, each case at its own tolerance.

The cases call ``.astype`` on what some functions return, as a JAX or numpy
array has it; the port returns torch tensors. So the cases see the port
through :class:`_HostArrays`, which hands every tensor that a function
returns to the case as the numpy array of the same values (what the cases'
own ``np.asarray`` does), and changes nothing else.
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

import golden_cases
from torch_threads import one_torch_thread  # noqa: F401 (autouse, one intra-op thread)
import librosa_tpu_torch

GOLDEN_DIR = Path(__file__).parent / "goldens"
PORTED = ["filters_mel", "melspectrogram", "mfcc", "mfcc_configs", "filters_chroma",
          "normalize_configs", "stft", "stft_configs", "db_scaling", "chroma_stft",
          "spectrogram_inputs", "istft_roundtrip", "istft_windows", "piptrack",
          "piptrack_configs", "tuning", "filters_misc", "synth", "convert_grids",
          "default_semantics", "interval_systems", "filters_wavelet", "cqt", "vqt", "vqt_gamma",
          "pseudo_hybrid_cqt", "icqt", "cqt_configs", "chroma_cqt", "chroma_cens", "chroma_vqt",
          "hpss_margin", "hpss_configs", "audio_ops", "zero_crossings", "stream_blocks",
          "lpc_burg_noise", "convert_units", "weighting_multi", "hpss_effect", "onset",
          "onset_strength", "onset_backtrack", "superflux", "beat", "plp", "rhythm",
          "rhythm_extras", "tempo_configs", "fourier_tempo_variants", "yin", "yin_configs", "pyin",
          "viterbi", "util_peak_pick", "util_matching", "sync_aggregates", "harmonics",
          "harmonics_2d", "util_sparsify", "dtw", "rqa", "recurrence", "cross_similarity",
          "notation", "convert_notes", "phase_vocoder", "time_stretch", "pitch_shift",
          "remix_effect", "preemphasis", "trim_split", "nn_filter", "spectral_descriptors",
          "tonnetz", "feature_manip", "delta_configs", "mfcc_to_mel", "util_core", "util_more",
          "fused_branch_configs", "pcen", "pcen_maxfilter", "reassigned", "iirt", "iirt_ba",
          "fmt", "path_enhance", "segment_cluster"]


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, tuple):
        return tuple(_to_host(v) for v in x)
    return x


class _HostArrays:
    """A module of the port whose functions return numpy arrays where the port returns tensors."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        attr = getattr(self._module, name)
        if isinstance(attr, types.ModuleType):
            return _HostArrays(attr)
        if callable(attr) and not isinstance(attr, type):
            return lambda *args, **kwargs: _to_host(attr(*args, **kwargs))
        return attr


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = librosa_tpu_torch.get_device()
    librosa_tpu_torch.set_device("cpu")
    yield
    librosa_tpu_torch.set_device(prev)


@pytest.fixture(scope="module")
def signals():
    return golden_cases.make_signals()


@pytest.mark.parametrize("name", PORTED)
def test_golden_port(name, signals):
    case = golden_cases.CASES[name]
    want = np.load(GOLDEN_DIR / f"{name}.npz")
    got = case.fn(_HostArrays(librosa_tpu_torch), signals)
    assert set(got) == set(want.files), (name, sorted(got), sorted(want.files))
    for key in want.files:
        w, g, label = want[key], np.asarray(got[key]), f"{name}/{key}"
        if case.compare is not None:
            case.compare(g, w, label)
        elif w.dtype.kind in ("U", "S"):  # note and svara names
            assert np.array_equal(g.astype(w.dtype), w), label
        else:
            assert g.shape == w.shape, (label, g.shape, w.shape)
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=case.rtol, atol=case.atol, err_msg=label)
