"""The port's public names against the JAX package's four ``.pyi`` stubs, in both directions.

``NOT_PORTED`` lists, for each stub, the names the port does not have yet.
A stub name that the port lacks and that is not listed fails; so does a
listed name that turns up in the port, so the list can only shrink. A
public name of the port that no stub has fails too, except the port's own
``PORT_OWN``. Submodules of the port that no stub names (``io``, ``entry``,
the modules behind a namespace) are the port's layout and are not counted.
"""

import __future__
import ast
import types
from pathlib import Path

import pytest

import librosa_tpu_torch as L

ROOT = Path(__file__).resolve().parent.parent
STUBS = {
    "librosa_tpu/__init__.pyi": L,
    "librosa_tpu/core/__init__.pyi": L.core,
    "librosa_tpu/feature/__init__.pyi": L.feature,
    "librosa_tpu/util/__init__.pyi": L.util,
}
PORT_OWN = {"librosa_tpu/__init__.pyi": {"get_device", "set_device"}}
NOT_PORTED = {
    "librosa_tpu/__init__.pyi": set(),
    "librosa_tpu/core/__init__.pyi": set(),
    "librosa_tpu/feature/__init__.pyi": set(),
    "librosa_tpu/util/__init__.pyi": set(),
}


def stub_names(stub: str) -> set:
    names = set()
    for node in ast.parse((ROOT / stub).read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.AnnAssign):
            names.add(node.target.id)
    return names


def port_names(module) -> set:
    """Public names of ``module``, submodules and ``from __future__`` features left out."""
    return {n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), (types.ModuleType, __future__._Feature))}


def port_modules(module) -> set:
    return {n for n in dir(module) if isinstance(getattr(module, n), types.ModuleType)}


@pytest.mark.parametrize("stub", list(STUBS))
def test_every_stub_name_is_ported_or_listed(stub):
    module = STUBS[stub]
    missing = stub_names(stub) - port_names(module) - port_modules(module)
    assert not missing - NOT_PORTED[stub], f"missing and not listed: {sorted(missing - NOT_PORTED[stub])}"
    arrived = NOT_PORTED[stub] - missing
    assert not arrived, f"ported now, take them off NOT_PORTED: {sorted(arrived)}"


@pytest.mark.parametrize("stub", list(STUBS))
def test_every_port_name_is_in_the_stub(stub):
    extra = port_names(STUBS[stub]) - stub_names(stub) - PORT_OWN.get(stub, set())
    assert not extra, f"public names no stub has: {sorted(extra)}"


def test_this_slice_is_off_the_list():
    earlier = {"load", "loadx", "stream", "to_mono", "to_stereo", "to_multi", "get_duration",
               "get_samplerate", "autocorrelate", "lpc", "zero_crossings", "mu_compress",
               "mu_expand", "samples_to_frames", "frames_to_time", "time_to_frames",
               "samples_to_time", "blocks_to_frames", "blocks_to_samples", "blocks_to_time",
               "multi_frequency_weighting", "times_like", "samples_like", "example", "ex",
               "cite", "frame", "zero_crossing_rate", "is_positive_int", "list_examples",
               "example_info", "find_files", "Deprecated", "rename_kw"}
    # the rest of feature and util, pcen and the spectral extensions
    slice_names = {"pcen", "reassigned_spectrogram", "iirt", "fmt", "delta", "stack_memory",
                   "inverse", "mel_to_stft", "mel_to_audio", "mfcc_to_mel", "mfcc_to_audio",
                   "spectral_bandwidth", "spectral_contrast", "spectral_flatness",
                   "poly_features", "tonnetz", "MAX_MEM_BLOCK", "valid_audio",
                   "valid_intervals", "cyclic_gradient", "stack", "count_unique", "is_unique",
                   "buf_to_float", "interp_broadcast", "nnls"}
    for stub in STUBS:
        listed = (earlier | slice_names) & NOT_PORTED[stub]
        assert not listed, (stub, sorted(listed))
    for name in ("load", "stream", "to_mono", "lpc", "zero_crossings", "times_like", "pcen"):
        assert getattr(L, name) is getattr(L.core, name)
    assert L.example is L.util.example and L.util.frame is L.util.utils.frame
    assert L.iirt is L.core.spectrum_ext.iirt and L.fmt is L.core.spectrum_ext.fmt
    assert L.feature.mel_to_stft is L.feature.inverse.mel_to_stft
    assert L.util.nnls is L.util._nnls.nnls and L.util.stack is L.util.utils.stack


def test_the_structure_and_infrastructure_slice_is_off_the_list():
    # parallel, the last name, came off the list with the sharded layer
    assert all(not names for names in NOT_PORTED.values())
    assert L.cache is L._cache.cache and {"display", "parallel"} <= set(dir(L))
    assert L.display.specshow is L.display.__dict__["specshow"]
    for name in ("timelag_filter", "subsegment", "agglomerative", "path_enhance"):
        assert callable(getattr(L.segment, name))
    for name in ("trace", "annotate", "dispatch_profile", "calibrate", "roofline",
                 "DeviceCeilings", "RooflineReport"):
        assert callable(getattr(L.util.profiling, name))
