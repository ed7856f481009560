"""Golden replay against the PyTorch port (the suites of what it has ported).

The same case table and fixtures as tests/test_goldens.py, which hold the
JAX package to the upstream reference, run here with ``L =
librosa_tpu_torch`` on the CPU, each case at its own tolerance.
"""

from pathlib import Path

import numpy as np
import pytest

import golden_cases
import librosa_tpu_torch

GOLDEN_DIR = Path(__file__).parent / "goldens"
PORTED = ["filters_mel", "melspectrogram", "mfcc", "mfcc_configs", "filters_chroma",
          "normalize_configs", "stft", "stft_configs", "db_scaling", "chroma_stft",
          "spectrogram_inputs", "istft_roundtrip", "istft_windows", "piptrack",
          "piptrack_configs", "tuning", "filters_misc", "synth", "convert_grids",
          "default_semantics", "interval_systems", "filters_wavelet", "cqt", "vqt", "vqt_gamma",
          "pseudo_hybrid_cqt", "icqt", "cqt_configs", "chroma_cqt", "chroma_cens", "chroma_vqt",
          "hpss_margin", "hpss_configs"]


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
    got = case.fn(librosa_tpu_torch, signals)
    assert set(got) == set(want.files), (name, sorted(got), sorted(want.files))
    for key in want.files:
        w, g, label = want[key], np.asarray(got[key]), f"{name}/{key}"
        if case.compare is not None:
            case.compare(g, w, label)
        else:
            assert g.shape == w.shape, (label, g.shape, w.shape)
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=case.rtol, atol=case.atol, err_msg=label)
