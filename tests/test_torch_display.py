"""The port's ``display`` (Agg backend), against the JAX package's tests and image baselines.

- The counterparts of ``tests/test_display.py``: the same calls and
  artist-level checks with ``lt`` the port, on the CPU.
- Every case of ``tests/display_baseline_cases.py`` rendered through the
  port and held against ``tests/display_baselines/*.npz`` under
  ``tests/test_display_images.py``'s rule: fewer than 0.5 % of pixels may
  move by more than 8 levels (measured: none moves).
- ``specshow`` of the same numpy data through both packages, and of a
  tensor against its numpy values: the same pixels, exactly.
"""

import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

import display_baseline_cases as dbc
import librosa_tpu_torch as lt
import librosa_tpu_torch.core.convert

display = lt.display

BASE = Path(__file__).parent / "display_baselines"
# the modules that the case table imports, by the JAX package's names
ALIASED = {"librosa_tpu": lt, "librosa_tpu.core": lt.core,
           "librosa_tpu.core.convert": lt.core.convert}


@pytest.fixture(autouse=True)
def close_figs():
    prev = lt.get_device()
    lt.set_device("cpu")
    yield
    lt.set_device(prev)
    plt.close("all")


@pytest.fixture
def port_as_jax_package(monkeypatch):
    """``import librosa_tpu`` (and its core and convert modules) give the port's modules
    while the test runs; monkeypatch restores ``sys.modules`` after it."""
    for name, module in ALIASED.items():
        monkeypatch.setitem(sys.modules, name, module)


@pytest.mark.parametrize("name", list(dbc.CASES))
def test_port_renders_display_baseline(name, port_as_jax_package):
    want = np.load(BASE / f"{name}.npz")["img"]
    got = dbc.render_case(name)
    assert got.shape == want.shape, (got.shape, want.shape)
    frac_changed = (np.abs(got.astype(int) - want.astype(int)) > 8).mean()
    assert frac_changed < 0.005, f"{name}: {frac_changed:.2%} of pixels changed"


def _pixels(render) -> np.ndarray:
    fig, ax = plt.subplots(figsize=(4, 3), dpi=72)
    try:
        render(ax)
        fig.canvas.draw()
        return np.asarray(fig.canvas.buffer_rgba()).copy()
    finally:
        plt.close(fig)


def test_specshow_pixels_equal_the_jax_package(tone_440):
    from librosa_tpu import display as jax_display

    S = np.abs(np.fft.rfft(tone_440[:8192].reshape(16, 512), axis=-1)).T
    kw = dict(sr=22050, hop_length=512, x_axis="time", y_axis="log", vscale="dBFS")
    want = _pixels(lambda ax: jax_display.specshow(S, ax=ax, **kw))
    got = _pixels(lambda ax: display.specshow(S, ax=ax, **kw))
    assert np.array_equal(got, want)


def test_specshow_of_a_tensor_equals_its_numpy_values(tone_440):
    S = np.abs(np.fft.rfft(tone_440[:8192].reshape(16, 512), axis=-1)).T.astype(np.float32)
    kw = dict(sr=22050, x_axis="time", y_axis="linear", vscale="dBFS")
    want = _pixels(lambda ax: display.specshow(S, ax=ax, **kw))
    got = _pixels(lambda ax: display.specshow(torch.from_numpy(S), ax=ax, **kw))
    assert np.array_equal(got, want)


def test_port_specshow_db(tone_440):
    S = np.asarray(lt.power_to_db(lt.feature.melspectrogram(y=tone_440)))
    fig, ax = plt.subplots()
    img = display.specshow(S, x_axis="time", y_axis="mel", ax=ax)
    assert img is not None
    assert ax.get_xlabel() == "Time"
    fig.canvas.draw()


def test_port_specshow_cqt_note(tone_440):
    C = np.abs(np.asarray(lt.cqt(tone_440, n_bins=48, res_type="polyphase")))
    fig, ax = plt.subplots()
    display.specshow(
        lt.power_to_db(C**2), x_axis="s", y_axis="cqt_note", ax=ax
    )
    assert ax.get_yscale() == "symlog"
    fig.canvas.draw()


def test_port_specshow_chroma(tone_440):
    ch = np.asarray(lt.feature.chroma_stft(y=tone_440, tuning=0.0))
    fig, ax = plt.subplots()
    display.specshow(ch, y_axis="chroma", x_axis="frames", ax=ax)
    fig.canvas.draw()
    labels = [t.get_text() for t in ax.get_yticklabels()]
    assert "C" in labels and "A" in labels


def test_port_specshow_tonnetz(tone_440):
    ch = np.asarray(lt.feature.chroma_stft(y=tone_440, tuning=0.0))
    tn = np.asarray(lt.feature.tonnetz(chroma=ch))
    fig, ax = plt.subplots()
    display.specshow(tn, y_axis="tonnetz", ax=ax)
    fig.canvas.draw()


def test_port_waveshow(tone_440):
    fig, ax = plt.subplots()
    awp = display.waveshow(tone_440, sr=22050, ax=ax)
    assert isinstance(awp, display.AdaptiveWaveplot)
    fig.canvas.draw()
    # long signal → envelope visible, steps hidden
    assert awp.envelope.get_visible()


def test_port_waveshow_short():
    y = lt.tone(440, duration=0.1).astype(np.float32)
    fig, ax = plt.subplots()
    awp = display.waveshow(y, sr=22050, ax=ax)
    fig.canvas.draw()
    assert awp.steps.get_visible()


def test_port_wavebars(tone_440):
    fig, ax = plt.subplots()
    bars = display.wavebars(np.asarray(tone_440), ax=ax, n_bars=40)
    assert len(bars.get_paths()) == 40


def test_port_colorbars(tone_440):
    S = np.asarray(lt.power_to_db(lt.feature.melspectrogram(y=tone_440)))
    fig, ax = plt.subplots()
    img = display.specshow(S, ax=ax)
    cb = display.colorbar_db(img, ax=ax)
    assert cb is not None

    phase = np.angle(np.asarray(lt.stft(tone_440)))[:64, :64]
    fig2, ax2 = plt.subplots()
    img2 = display.specshow(phase, ax=ax2, cmap="twilight")
    cb2 = display.colorbar_phase(img2, ax=ax2)
    assert cb2 is not None


def test_port_multiplot(tone_440):
    S = np.asarray(lt.power_to_db(lt.feature.melspectrogram(y=tone_440)))
    arts = display.multiplot("specshow", S, S, S, x_axis="time", y_axis="mel")
    assert arts.size == 3
    # stacked-array input: leading dim indexes subplots
    arts2 = display.multiplot("specshow", np.stack([S, S]), x_axis="time")
    assert arts2.size == 2


def test_port_highlight():
    fig, ax = plt.subplots()
    (line,) = ax.plot([0, 1], [0, 1])
    effects = display.highlight(artist=line)
    assert len(effects) == 1
    assert line.get_path_effects() == effects
    # explicit color bypasses luminance inference
    effects2 = display.highlight(ax=ax, color="red")
    assert len(effects2) == 1


def test_port_time_formatter():
    f = display.TimeFormatter()

    class FakeAxis:
        def get_data_interval(self):
            return (0, 10)

        def get_view_interval(self):
            return (0, 10)

    f.axis = FakeAxis()
    assert f(1.5) == "1.50"


def test_port_chroma_formatter():
    f = display.ChromaFormatter()
    assert f(0) == "C"
    assert f(9) == "A"


def test_port_cmap_inference(rng):
    seq = display.cmap(np.abs(rng.randn(100)))
    div = display.cmap(rng.randn(1000))
    b = display.cmap(np.array([True, False]))
    assert seq.name == "magma"
    assert div.name == "coolwarm"
    assert b.name == "gray_r"


def test_port_infer_cmap_div_thresh(rng):
    data = np.abs(rng.randn(500)) + 1.0
    assert display.infer_cmap(data).name == "magma"
    # raising the threshold into the data range flips to diverging
    assert display.infer_cmap(data, div_thresh=float(np.median(data))).name == "coolwarm"


def test_port_chroma_fjs_formatter():
    f = display.ChromaFJSFormatter(intervals="ji5", bins_per_octave=12)
    assert f(0) == "C"
    assert f(12) == f(0)
    with pytest.raises(lt.ParameterError):
        display.ChromaFJSFormatter(intervals="ji5", bins_per_octave=None)


def test_port_transformf0_roundtrip():
    f0 = np.array([110.0, 220.0, np.nan, 110.0])
    t = display.Transformf0(f0)
    vals = np.array([[0.0, 0.0], [0.023, 12.0]])
    fwd = t.transform_non_affine(vals)
    assert np.allclose(fwd[:, 1], [110.0, 220.0])
    back = t.inverted().transform_non_affine(fwd)
    assert np.allclose(back, vals)
    with pytest.raises(lt.ParameterError):
        display.Transformf0(np.array([np.nan, np.nan]))


def test_port_specshow_vscale_dbfs(tone_440):
    D = np.asarray(lt.stft(np.asarray(tone_440)))
    fig, ax = plt.subplots()
    img = display.specshow(D, x_axis="time", y_axis="log", vscale="dBFS", ax=ax)
    # dBFS: max-referenced dB, so the top of the color range is 0
    assert float(img.get_array().max()) <= 1e-5
    with pytest.raises(lt.ParameterError):
        display.specshow(D, vscale="dBFS[0.5]", ax=ax)
    with pytest.raises(lt.ParameterError):
        display.specshow(D, vscale="nonsense", ax=ax)


def test_port_specshow_vscale_phase(tone_440):
    D = np.asarray(lt.stft(np.asarray(tone_440)))
    fig, ax = plt.subplots()
    img = display.specshow(D, vscale="phase", ax=ax)
    arr = np.asarray(img.get_array())
    assert arr.min() >= -np.pi - 1e-6 and arr.max() <= np.pi + 1e-6
    cb = display.colorbar_phase(img, ax=ax)
    assert cb is not None


def test_port_waveshow_mask_and_invert(tone_440):
    y = np.asarray(tone_440)
    fig, ax = plt.subplots()
    mask = np.zeros(len(y), dtype=bool)
    mask[len(y) // 2:] = True
    ad = display.waveshow(y, ax=ax, mask=mask, invert=True)
    assert ad.envelope is not None
    ad.disconnect()
    ad.disconnect()  # idempotent
    with pytest.raises(lt.ParameterError):
        ad.disconnect(strict=True)


def test_port_wavef0_displacement(tone_440):
    y = np.asarray(tone_440)
    n_frames = 1 + len(y) // 512
    f0 = np.full(n_frames, 440.0)
    f0[:2] = np.nan
    fig, ax = plt.subplots()
    ad = display.wavef0(y, f0=f0, sr=22050, ax=ax)
    assert isinstance(ad, display.AdaptiveWaveplot)
    fig, ax = plt.subplots()
    pc = display.wavef0(y, f0=f0, sr=22050, ax=ax, method="wavebars", n_bars=32)
    assert len(pc.get_paths()) == 32
    with pytest.raises(lt.ParameterError):
        display.wavef0(y, f0=f0, method="bogus")


def test_port_legend_for_axes_collects_labels():
    fig, axes = plt.subplots(nrows=2)
    axes[0].plot([0, 1], label="a")
    axes[1].plot([1, 0], label="b")
    leg = display.legend_for_axes(axes=axes)
    assert len(leg.get_texts()) == 2
    with pytest.raises(lt.ParameterError):
        display.legend_for_axes(axes=[])


@pytest.mark.parametrize(
    "y_axis,kw",
    [
        ("oct3", {}),
        ("log_oct3", {}),
        ("mel_oct3", {}),
        ("cqt_oct3", {}),
        ("vqt_hz", {"intervals": "ji5"}),
        ("vqt_note", {"intervals": "ji5"}),
        ("vqt_oct3", {"intervals": "ji5"}),
    ],
)
def test_port_specshow_extended_freq_axes(tone_440, y_axis, kw):
    S = np.abs(np.asarray(lt.stft(np.asarray(tone_440))))
    fig, ax = plt.subplots()
    display.specshow(S, sr=22050, y_axis=y_axis, x_axis="time", ax=ax, **kw)
    fig.canvas.draw()
    assert ax.get_ylabel() in ("Frequency", "Hz", "Note")


def test_port_specshow_chroma_fjs_axis(tone_440):
    S = np.abs(np.asarray(lt.stft(np.asarray(tone_440))))[:12]
    fig, ax = plt.subplots()
    display.specshow(
        S, sr=22050, y_axis="chroma_fjs", intervals="ji5", ax=ax
    )
    fig.canvas.draw()
    assert ax.get_ylabel() == "Pitch class"


@pytest.mark.parametrize("unit", ["h", "m", "s", "ms"])
def test_port_time_formatter_units(unit):
    f = display.TimeFormatter(unit=unit)

    class FakeAxis:
        def get_data_interval(self):
            return (0, 4000)

        def get_view_interval(self):
            return (0, 4000)

    f.axis = FakeAxis()
    assert isinstance(f(3725.0), str)
    with pytest.raises(lt.ParameterError):
        display.TimeFormatter(unit="days")


class _SpanAxis:
    """Minimal axis stub with a settable view interval."""

    def __init__(self, lo, hi):
        self.lo, self.hi = lo, hi

    def get_view_interval(self):
        return (self.lo, self.hi)


def test_port_adaptive_eng_formatter_zoom():
    # minor labels vanish beyond a 2-octave span and return when zoomed
    minor = display.AdaptiveEngFormatter(major=False, unit="Hz")
    major = display.AdaptiveEngFormatter(major=True, unit="Hz")
    minor.axis = major.axis = _SpanAxis(32, 8192)
    assert minor(1250.0) == ""
    assert major(1000.0) != ""
    minor.axis = major.axis = _SpanAxis(1000, 2500)
    assert minor(1250.0) != ""
    # inverted axes normalize
    minor.axis = _SpanAxis(2500, 1000)
    assert minor(1250.0) != ""
    # non-positive ticks are never labeled
    assert major(0.0) == "" and major(-5.0) == ""


def test_port_note_formatter_cents_zoom():
    f = display.NoteFormatter()
    f.axis = _SpanAxis(400, 10000)
    assert f(446.0) == "A4"            # wide span: no cent deviation
    f.axis = _SpanAxis(430, 460)
    assert "+" in f(446.0)             # inside one octave: cents appear


def test_port_adaptive_formatters_in_specshow(tone_440):
    # the oct3 axes wire adaptive Eng formatters on major AND minor ticks
    S = np.abs(np.asarray(lt.stft(np.asarray(tone_440))))
    fig, ax = plt.subplots()
    display.specshow(S, sr=22050, y_axis="log_oct3", x_axis="time", ax=ax)
    fig.canvas.draw()
    assert isinstance(
        ax.yaxis.get_major_formatter(), display.AdaptiveEngFormatter
    )
    assert isinstance(
        ax.yaxis.get_minor_formatter(), display.AdaptiveEngFormatter
    )
    wide_minor = [
        ax.yaxis.get_minor_formatter()(v) for v in (125.0, 250.0)
    ]
    ax.set_ylim(100, 300)
    fig.canvas.draw()
    zoom_minor = [
        ax.yaxis.get_minor_formatter()(v) for v in (125.0, 250.0)
    ]
    assert all(s == "" for s in wide_minor)
    assert all(s != "" for s in zoom_minor)
