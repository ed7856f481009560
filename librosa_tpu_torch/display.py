"""Spectrogram and waveform display with matplotlib, on the host.

The JAX package's ``display`` surface: ``specshow`` with its axis types
and tick formatting, the adaptive ``waveshow``, ``wavebars``, ``wavef0``,
the dB and phase colorbars, ``multiplot``, ``highlight`` and the tick
formatters. Every array it is given, a tensor on any device included,
comes to the host through :func:`_host` before matplotlib sees it; so do
the tensors that the port's own ``power_to_db``, ``amplitude_to_db`` and
``to_mono`` return. The package imports this module only when
``librosa_tpu_torch.display`` is first used, so that importing the package
does not import matplotlib.
"""

from __future__ import annotations

from typing import Any, Callable, Collection, List, Optional, Sequence, Union

import numpy as np

from . import core
from .core import convert
from .util.exceptions import ParameterError
from .util.utils import _host as _to_host

__all__ = [
    "specshow",
    "waveshow",
    "wavebars",
    "wavef0",
    "colorbar_db",
    "colorbar_phase",
    "multiplot",
    "legend_for_axes",
    "highlight",
    "cmap",
    "TimeFormatter",
    "AdaptiveFormatterBase",
    "AdaptiveEngFormatter",
    "NoteFormatter",
    "LogHzFormatter",
    "ChromaFormatter",
    "ChromaSvaraFormatter",
    "SvaraFormatter",
    "TonnetzFormatter",
    "FJSFormatter",
    "ChromaFJSFormatter",
    "AdaptiveWaveplot",
    "Transformf0",
    "infer_cmap",
]


def _host(x: Any, dtype: Any = None) -> np.ndarray:
    """``x`` as a numpy array (of ``dtype``) on the host; a tensor is copied off its device."""
    return np.asarray(_to_host(x), dtype=dtype)


def _mpl():
    import matplotlib

    if matplotlib.get_backend().lower() not in ("agg",):
        try:
            import matplotlib.pyplot  # noqa: F401
        except Exception:
            matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# ---------------------------------------------------------------------------
# Tick formatters (reference display.py:182-860)
# ---------------------------------------------------------------------------

from matplotlib.ticker import Formatter


class TimeFormatter(Formatter):
    """Time-axis tick formatter with span-adaptive units.

    With ``unit=None`` the format adapts to the visible span: hours as
    ``h:mm:ss``, minutes as ``m:ss``, seconds with two decimals, and
    sub-second values in scientific-free ``%g``.  Explicit units
    (``'h'``, ``'m'``, ``'s'``, ``'ms'``) pin the scale; ``lag=True``
    renders positions past the midpoint as negative lags.

    Parameters
    ----------
    lag : bool
        format as a lag axis (second half counts backwards)
    unit : {'h', 'm', 's', 'ms', None}
        fixed display unit, or None for adaptive formatting

    Raises
    ------
    ParameterError
        for an unknown unit

    Parity: reference display.py:182.
    """

    def __init__(self, lag: bool = False, unit: Optional[str] = None):
        if unit not in ["h", "m", "s", "ms", None]:
            raise ParameterError(f"Unknown time unit: {unit}")
        self.unit = unit
        self.lag = lag

    def __call__(self, x: float, pos: Optional[int] = None) -> str:
        _, dmax = self.axis.get_data_interval()
        vmin, vmax = self.axis.get_view_interval()

        if self.lag and x >= dmax * 0.5:
            value = x - dmax
            sign = "-"
        else:
            value = x
            sign = ""

        if self.unit == "s":
            s = f"{value:.3g}"
        elif self.unit == "ms":
            s = f"{value * 1000:.3g}"
        elif self.unit == "h":
            s = "{:d}:{:02d}:{:02d}".format(
                int(value / 3600.0),
                int(np.mod(value / 60.0, 60)),
                int(np.mod(value, 60)),
            )
        elif self.unit == "m":
            s = "{:d}:{:02d}".format(int(value / 60.0), int(np.mod(value, 60)))
        else:
            if vmax - vmin > 3600:
                s = "{:d}:{:02d}:{:02d}".format(
                    int(value / 3600.0),
                    int(np.mod(value / 60.0, 60)),
                    int(np.mod(value, 60)),
                )
            elif vmax - vmin > 60:
                s = "{:d}:{:02d}".format(
                    int(value / 60.0), int(np.mod(value, 60))
                )
            elif vmax - vmin >= 1:
                s = f"{value:0.2f}"
            else:
                s = f"{value:g}"
        return f"{sign:s}{s:s}"


class AdaptiveFormatterBase(Formatter):
    """Frequency-tick formatter whose labels react to the zoom level.

    Non-positive tick positions are never labeled.  A formatter built
    with ``major=False`` (the minor-tick role) only labels its ticks
    while the visible span is narrower than two octaves — zoomed out,
    minor labels vanish and the major grid carries the axis alone.
    Subclasses render one tick via ``_format_tick`` and may consult
    ``self.vmin``/``self.vmax`` (the view interval, normalized for
    inverted axes) for their own precision decisions.

    Parity: reference display.py:293.
    """

    def __init__(self, major: bool = True):
        super().__init__()
        self.major = major
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def _span_within(self, octaves: float) -> bool:
        """True iff the current view spans at most ``octaves`` octaves."""
        return self.vmax <= (2.0 ** octaves) * max(1, self.vmin)

    def __call__(self, x: float, pos: Optional[int] = None) -> str:
        if x <= 0:
            return ""
        lo, hi = self.axis.get_view_interval()
        self.vmin, self.vmax = (lo, hi) if lo <= hi else (hi, lo)
        if not self.major and not self._span_within(2):
            return ""
        return self._format_tick(x, pos)

    def _format_tick(self, x: float, pos: Optional[int] = None) -> str:
        raise NotImplementedError


class AdaptiveEngFormatter(AdaptiveFormatterBase):
    """Engineering-notation Hz ticks with two-octave minor suppression.

    Renders frequency ticks as SI-prefixed engineering notation
    (``250``, ``1k``, ``16k``) via :class:`matplotlib.ticker.EngFormatter`,
    while the adaptive base decides *whether* a label appears at the
    current zoom: a ``major=False`` instance labels its (minor) ticks
    only when the visible span is at most two octaves, so zoomed-out
    axes stay uncluttered.  Used by ``specshow(..., axis='log')`` and
    the frequency colorbars.

    Parameters
    ----------
    major : bool
        formatter role; ``False`` enables the two-octave suppression
    **kwargs
        forwarded to :class:`matplotlib.ticker.EngFormatter`
        (e.g. ``unit``, ``places``)

    Parity: reference display.py:624.
    """

    def __init__(self, major: bool = True, **kwargs: Any):
        super().__init__(major=major)
        from matplotlib.ticker import EngFormatter

        self._eng = EngFormatter(**kwargs)

    def _format_tick(self, x: float, pos: Optional[int] = None) -> str:
        return self._eng(x, pos)


class NoteFormatter(AdaptiveFormatterBase):
    """Frequency ticks rendered as note names (e.g. ``A4``).

    Inherits the adaptive span behavior of
    :class:`AdaptiveFormatterBase`; additionally, cent deviations
    (``A4+23``) appear only when the view spans at most one octave.

    Parameters
    ----------
    octave : bool
        include the octave number
    major : bool
        label always (True) or only inside a two-octave span (False)
    key : str
        key signature for sharp/flat spelling
    unicode : bool
        unicode accidental symbols

    Parity: reference display.py:336.
    """

    def __init__(
        self, octave: bool = True, major: bool = True, key: str = "C:maj",
        unicode: bool = True,
    ):
        super().__init__(major=major)
        self.octave = octave
        self.key = key
        self.unicode = unicode

    def _format_tick(self, x: float, pos: Optional[int] = None) -> str:
        # cent deviations only make sense once zoomed inside one octave
        return str(
            convert.hz_to_note(
                x, octave=self.octave, cents=self._span_within(1),
                key=self.key, unicode=self.unicode,
            )
        )


class SvaraFormatter(AdaptiveFormatterBase):
    """Frequency ticks rendered as Hindustani/Carnatic svara names.

    With ``mela=None`` labels use Hindustani svara relative to the
    tonic ``Sa``; a melakarta index/name switches to Carnatic spelling.
    Minor-tick instances blank out beyond a two-octave span.

    Parameters
    ----------
    Sa : float > 0
        tonic frequency in Hz
    octave : bool
        mark upper/lower octaves
    major : bool
        label always (True) or only when zoomed in (False)
    abbr : bool
        single-letter svara abbreviations
    mela : str, int, or None
        melakarta raga for Carnatic spelling
    unicode : bool
        unicode octave markers

    Parity: reference display.py:405.
    """

    def __init__(
        self, Sa: float, octave: bool = True, major: bool = True,
        abbr: bool = False, mela: Optional[Union[str, int]] = None,
        unicode: bool = True,
    ):
        if Sa is None:
            raise ParameterError("Sa frequency is required for svara display")
        super().__init__(major=major)
        self.Sa = Sa
        self.mela = mela
        self.abbr = abbr
        self.octave = octave
        self.unicode = unicode

    def _format_tick(self, x: float, pos: Optional[int] = None) -> str:
        if self.mela is None:
            return str(
                convert.hz_to_svara_h(
                    x, Sa=self.Sa, abbr=self.abbr, octave=self.octave,
                    unicode=self.unicode,
                )
            )
        return str(
            convert.hz_to_svara_c(
                x, Sa=self.Sa, mela=self.mela, abbr=self.abbr,
                octave=self.octave, unicode=self.unicode,
            )
        )


class FJSFormatter(AdaptiveFormatterBase):
    """Frequency ticks rendered in Functional Just System (FJS) notation.

    Labels log-frequency axes of just-intonation VQT plots: each tick
    frequency is named relative to ``fmin`` in FJS (note name plus comma
    accidentals, e.g. ``A♭⁵`` with superscript otonal factors).  When the
    bin grid is known (``n_bins`` + ``intervals``) each tick is first
    snapped to the nearest just-intonation bin frequency, so labels stay
    exact on log-spaced vqt axes; ticks that cannot be named in the
    system render empty rather than erroring.

    Parameters
    ----------
    fmin : float
        frequency of the unison (bin 0)
    unison : str or None
        note name of the unison; None infers it from ``fmin``
    major : bool
        minor-tick instances blank out beyond a two-octave span
    unicode : bool
        unicode accidental/superscript glyphs
    intervals, n_bins, bins_per_octave
        the VQT bin grid to snap ticks onto (optional)

    Parity: reference display.py:494.
    """

    def __init__(
        self, *, fmin: float, unison: Optional[str] = None,
        major: bool = True, unicode: bool = True,
        intervals: Optional[Any] = None, n_bins: Optional[int] = None,
        bins_per_octave: int = 12,
    ):
        super().__init__(major=major)
        self.fmin = fmin
        self.unison = unison
        self.unicode = unicode
        self.intervals = intervals
        self.n_bins = n_bins
        self.bins_per_octave = bins_per_octave
        self.frequencies_: Optional[np.ndarray] = None
        if intervals is not None and n_bins is not None:
            from .core.intervals import interval_frequencies

            self.frequencies_ = _host(
                interval_frequencies(
                    n_bins, fmin=fmin, intervals=intervals,
                    bins_per_octave=bins_per_octave,
                )
            )

    def _format_tick(self, x: float, pos: Optional[int] = None) -> str:
        if self.frequencies_ is not None:
            from .util.matching import match_events

            idx = match_events(np.atleast_1d(x), self.frequencies_)[0]
            x = float(self.frequencies_[idx])
        try:
            return str(
                convert.hz_to_fjs(
                    x, fmin=self.fmin, unison=self.unison,
                    unicode=self.unicode,
                )
            )
        except ParameterError:
            return ""


class LogHzFormatter(AdaptiveFormatterBase):
    """Plain-Hz ticks for log-scaled frequency axes.

    Renders each tick as ``%g`` Hz; minor-tick instances
    (``major=False``) blank out when the view spans more than two
    octaves, leaving the octave grid readable.

    Parameters
    ----------
    major : bool
        label always (True) or only when zoomed in (False)

    Parity: reference display.py:588.
    """

    def _format_tick(self, x: float, pos: Optional[int] = None) -> str:
        return f"{x:g}"


class ChromaFormatter(Formatter):
    """Pitch-class (chroma bin) ticks rendered as note names.

    Labels the vertical axis of chromagrams (``specshow(..,
    axis='chroma')``): tick position ``x`` is reduced modulo 12 to a
    pitch class and spelled according to the key signature — bin 0 maps
    to C, and accidentals (sharp vs flat spelling) follow ``key``, so a
    plot in A♭ major reads ``A♭`` rather than ``G♯``.  Spelling comes
    from :func:`librosa_tpu_torch.key_to_notes`.

    Parameters
    ----------
    key : str
        key signature for spelling, e.g. ``'C:maj'``, ``'Eb:min'``
    unicode : bool
        render accidentals with unicode symbols (``♯``/``♭``) instead
        of ASCII (``#``/``b``)

    Parity: reference display.py:647.
    """

    def __init__(self, key: str = "C:maj", unicode: bool = True):
        from .core.notation import key_to_notes

        self.notes = key_to_notes(key, unicode=unicode)

    def __call__(self, x: float, pos: Optional[int] = None) -> str:
        return self.notes[int(x) % 12]


class ChromaSvaraFormatter(Formatter):
    """Pitch-class ticks rendered as svara names.

    Like :class:`ChromaFormatter` but labels bins relative to ``Sa``
    with Hindustani (``mela=None``) or Carnatic spelling.

    Parameters
    ----------
    Sa : int
        chroma bin of the tonic
    mela : str, int, or None
        melakarta raga for Carnatic spelling
    abbr : bool
        abbreviated svara names
    unicode : bool
        unicode symbols

    Parity: reference display.py:690.
    """

    def __init__(
        self, Sa: Optional[float] = None, mela: Optional[Any] = None,
        abbr: bool = True, unicode: bool = True,
    ):
        from .core.notation import mela_to_svara

        if Sa is None:
            Sa = 0
        self.Sa_idx = int(np.round(Sa)) % 12
        if mela is not None:
            self.names = mela_to_svara(mela, abbr=abbr, unicode=unicode)
        else:
            self.names = [
                "S", "r", "R", "g", "G", "m", "M", "P", "d", "D", "n", "N",
            ]

    def __call__(self, x: float, pos: Optional[int] = None) -> str:
        return self.names[int(x - self.Sa_idx) % 12]


class ChromaFJSFormatter(Formatter):
    """Pitch-class ticks in Functional Just System (FJS) notation.

    Labels each chroma bin by the FJS name of its interval above the
    unison, for axes produced with just-intonation ``intervals``.

    Parameters
    ----------
    intervals : str or array
        interval set (e.g. ``'ji5'``) defining the bin grid
    unison : str
        unison note name
    unicode : bool
        unicode superscripts in comma annotations
    bins_per_octave : int > 0
        bins per octave of the chroma axis

    Parity: reference display.py:758.
    """

    def __init__(
        self, *, intervals: Any, unison: str = "C", unicode: bool = True,
        bins_per_octave: Optional[int] = None,
    ):
        from .core.intervals import interval_frequencies

        self.unison = unison
        self.unicode = unicode
        self.intervals = intervals
        try:
            if not isinstance(intervals, str):
                bins_per_octave = len(intervals)
            if not isinstance(bins_per_octave, int):
                raise ParameterError(
                    f"bins_per_octave={bins_per_octave} must be integer-valued"
                )
            self.bins_per_octave = bins_per_octave
            self.intervals_ = interval_frequencies(
                self.bins_per_octave, fmin=1, intervals=intervals,
                bins_per_octave=self.bins_per_octave,
            )
        except TypeError as exc:
            raise ParameterError(
                f"intervals={intervals} must be of type str or a collection "
                "of numbers between 1 and 2"
            ) from exc

    def __call__(self, x: float, pos: Optional[int] = None) -> str:
        from .core.notation import interval_to_fjs

        return str(
            interval_to_fjs(
                self.intervals_[int(x) % self.bins_per_octave],
                unison=self.unison, unicode=self.unicode,
            )
        )


class TonnetzFormatter(Formatter):
    """Ticks naming the six tonnetz (tonal-centroid) dimensions.

    Labels the vertical axis of :func:`librosa_tpu_torch.feature.tonnetz`
    plots (``specshow(.., axis='tonnetz')``): rows 0–5 are the sin/cos
    coordinate pairs of the three harmonic circles — perfect fifth
    (``5x``, ``5y``), minor third (``m3x``, ``m3y``), and major third
    (``M3x``, ``M3y``) — rendered with mathtext subscripts.  Positions
    are reduced modulo 6, so the formatter is safe on any integer
    locator.

    Parity: reference display.py:840.
    """

    def __call__(self, x: float, pos: Optional[int] = None) -> str:
        return [r"5$_x$", r"5$_y$", r"m3$_x$", r"m3$_y$", r"M3$_x$", r"M3$_y$"][
            int(x) % 6
        ]


# ---------------------------------------------------------------------------
# Adaptive waveform artist (reference display.py:862)
# ---------------------------------------------------------------------------


class AdaptiveWaveplot:
    """Switch between sample-level and envelope rendering on zoom.

    ``waveshow`` returns one of these: while the visible span holds at
    most ``max_samples`` samples a step plot of the raw waveform is
    shown; zoomed out, a min/max amplitude envelope replaces it.  The
    swap re-fires on every x-limit change once :meth:`connect` has
    registered the callback (done automatically by ``waveshow``).
    Artists are held by weak reference — the axes own them.

    Parity: reference display.py:862.
    """

    def __init__(self, times, y, steps, envelope, sr=22050,
                 max_samples=11025, transpose=False, label=None,
                 max_points=None):
        import weakref

        self.times = times
        self.y = y
        # artists are held by weak reference (reference display.py:930):
        # the axes own them; the waveplot must not keep them alive
        self._steps_ref = weakref.ref(steps)
        self._envelope_ref = weakref.ref(envelope)
        self.sr = sr
        # max_points kept as a deprecated alias of max_samples
        self.max_samples = max_points if max_points is not None else max_samples
        self.transpose = transpose
        self.label = label
        self.cid = None
        self._ax = None
        # Legend proxy: an invisible line carries the label so legends
        # render through the _WaveshowLegendKey handler (axes-background
        # swatch under a sample of the step line) instead of a bare
        # fill patch.  Parity: reference display.py:1092-1142.
        self.label_proxy_ = _WaveshowLabelProxy(self)
        self.label_proxy_.set_in_layout(False)
        if label is not None:
            self.label_proxy_.set_label(label)

    @property
    def steps(self):
        """The sample-level step-plot artist.

        A :class:`matplotlib.lines.Line2D` drawing the raw waveform,
        visible only while the view holds at most ``max_samples``
        samples (zoomed in far enough that individual samples are
        meaningful).  Held by weak reference — returns None once the
        axes (the owner) have released it, so callers should null-check
        before styling it.
        """
        return self._steps_ref()

    @property
    def envelope(self):
        """The zoomed-out amplitude-envelope artist.

        A :class:`matplotlib.collections.PolyCollection` filling between
        the per-bin min and max amplitudes, shown whenever the view
        spans more than ``max_samples`` samples — the standard audio
        editor "waveform overview" rendering.  Held by weak reference —
        returns None once the axes (the owner) have released it, so
        callers should null-check before styling it.
        """
        return self._envelope_ref()

    @property
    def max_points(self):
        """Deprecated alias of ``max_samples``.

        The zoom threshold (in samples visible) at which the display
        switches between the sample-level step plot and the min/max
        envelope.  Kept for signature parity with the reference's
        ``max_points`` constructor argument; new code should read
        ``max_samples`` directly.
        """
        return self.max_samples

    @property
    def ax(self):
        """The axes this waveplot is connected to (None before connect).

        Set by :meth:`connect` and cleared by :meth:`disconnect`; the
        zoom-adaptive callback registered on these axes re-fires
        :meth:`update` on every view-limit change.  The waveplot never
        owns the axes — it only holds them to unregister its callback.
        """
        return self._ax

    def update(self, ax) -> None:
        """Swap the visible artist to match the current view limits.

        Reads the axes' x-limits (y-limits when ``transpose``), converts
        the visible span to a sample count, and toggles visibility: the
        step plot when at most ``max_samples`` samples are in view, the
        min/max envelope otherwise.  Called automatically by the
        callback that :meth:`connect` registers; call it directly after
        programmatic ``set_xlim`` if no callback is attached.
        """
        if self.transpose:
            lims = ax.get_ylim()
        else:
            lims = ax.get_xlim()
        n_view = int((lims[1] - lims[0]) * self.sr)
        steps = self.steps
        envelope = self.envelope
        show_steps = n_view <= self.max_samples
        if steps is not None:
            steps.set_visible(show_steps)
        if envelope is not None:
            envelope.set_visible(not show_steps)

    def connect(self, ax, signal: str = "xlim_changed") -> None:
        """Register the zoom-adaptive callback on ``ax``.

        After connecting, every change of the watched view limits calls
        :meth:`update`, so interactive pans/zooms swap between the step
        plot and the envelope automatically.  ``signal`` may be an axes
        callback name (``xlim_changed`` / ``ylim_changed`` — use the
        latter for ``transpose=True`` plots) or any canvas event name
        (e.g. ``'draw_event'``), in which case the callback registers on
        the figure canvas instead.  ``waveshow`` calls this for you.
        """
        self._ax = ax
        if self.label_proxy_.axes is None:
            ax.add_artist(self.label_proxy_)
        if signal in ("xlim_changed", "ylim_changed"):
            self.cid = ax.callbacks.connect(
                signal, lambda a: self.update(a)
            )
        else:
            self.cid = ax.figure.canvas.mpl_connect(
                signal, lambda event: self.update(ax)
            )

    def disconnect(self, *, strict: bool = False) -> None:
        """Unregister the zoom-adaptive callback.

        Detaches whatever :meth:`connect` registered (axes callback or
        canvas event) and forgets the axes, freezing the plot in its
        current step-vs-envelope state.  With ``strict=True`` a
        disconnect without a prior connect raises
        :class:`ParameterError`; by default it is a silent no-op so
        teardown code can call it unconditionally.
        """
        if self.cid is None:
            if strict:
                raise ParameterError("AdaptiveWaveplot is not connected")
            return
        if self._ax is not None:
            try:
                self._ax.callbacks.disconnect(self.cid)
            except Exception:
                self._ax.figure.canvas.mpl_disconnect(self.cid)
        self.cid = None
        self._ax = None


def _make_waveshow_legend_proxy():
    """Build the legend stand-in class for AdaptiveWaveplot and teach
    matplotlib's legend machinery how to draw its key: the axes
    background color as a swatch, overlaid with a zero-data sample of
    the step line's style.  The waveplot's visible artist changes with
    zoom (step line vs envelope fill), so neither can reliably carry
    the legend entry; this invisible line does."""
    import matplotlib.lines as mlines
    import matplotlib.patches as mpatches
    from matplotlib.legend import Legend
    from matplotlib.legend_handler import (
        HandlerBase, HandlerLine2D, HandlerPatch,
    )

    class _WaveshowLabelProxy(mlines.Line2D):
        def __init__(self, waveplot, *args, **kwargs):
            kwargs["color"] = "none"
            super().__init__([], [], *args, **kwargs)
            self.waveplot = waveplot

    class _WaveshowLegendKey(HandlerBase):
        def create_artists(self, legend, orig_handle, xdescent, ydescent,
                           width, height, fontsize, trans):
            waveplot = orig_handle.waveplot
            box = (xdescent, ydescent, width, height, fontsize, trans)

            backdrop = mpatches.Rectangle(
                (0, 0), 1, 1, edgecolor="none",
                facecolor=(
                    waveplot.ax.get_facecolor()
                    if waveplot.ax is not None else "none"
                ),
            )
            swatch = HandlerPatch().create_artists(legend, backdrop, *box)

            stroke = mlines.Line2D([], [])
            if waveplot.steps is not None:
                stroke.update_from(waveplot.steps)
            stroke.set_data([], [])
            stroke.set(visible=True)
            sample = HandlerLine2D().create_artists(legend, stroke, *box)
            return [*swatch, *sample]

    if _WaveshowLabelProxy not in Legend.get_default_handler_map():
        Legend.update_default_handler_map(
            {_WaveshowLabelProxy: _WaveshowLegendKey()}
        )
    return _WaveshowLabelProxy


_WaveshowLabelProxy = _make_waveshow_legend_proxy()


def _make_transformf0():
    """Build the Transformf0 class lazily (needs matplotlib.transforms)."""
    import matplotlib.transforms as mtransforms

    class Transformf0(mtransforms.Transform):
        """f0-displacement transform for pitch-relative waveform display.

        Maps (time, value) pairs so that waveform samples ride the f0
        contour: forward maps a pitch-relative offset to absolute Hz via
        ``2**(v / norm / bins_per_octave) * f0(t)``; inverse maps back to
        pitch-relative log2 offsets.  Unvoiced (NaN) frames pass NaN
        through, hiding those samples.

        Parity: display.py:1145 (Transformf0).
        """

        input_dims = 2
        output_dims = 2
        is_separable = False

        def __init__(
            self, f0, *, sr: float = 22050, hop_length: int = 512,
            bins_per_octave: int = 12, norm: float = 1, offset: float = 0,
            transpose: bool = False, is_inverted: bool = False,
        ):
            super().__init__(shorthand_name="Transformf0")
            f0 = _host(f0, dtype=float)
            if not np.any(np.isfinite(f0)) or np.nanmin(f0) <= 0:
                raise ParameterError(
                    "f0 must be strictly positive (or NaN) and contain at "
                    "least one finite value"
                )

            import scipy.interpolate

            times = offset + convert.times_like(
                f0, sr=sr, hop_length=hop_length
            )
            self.f0_interp = scipy.interpolate.interp1d(
                _host(times), f0, kind="previous", copy=False,
                bounds_error=False, assume_sorted=True,
            )
            self.norm = norm
            self.bins_per_octave = bins_per_octave
            self.f0 = f0
            self.sr = sr
            self.hop_length = hop_length
            self.offset = offset
            self.transpose = transpose
            self.is_inverted = is_inverted

        def transform_non_affine(self, values):
            """Map (time, value) pairs along the f0 contour.

            Forward: a pitch-relative offset ``v`` at time ``t`` becomes
            absolute frequency ``2**(v / norm / bins_per_octave) · f0(t)``
            (zero-order-hold interpolation of f0).  Inverted instances
            map absolute Hz back to pitch-relative log2 offsets.  NaN f0
            (unvoiced) propagates, hiding those samples.  ``values`` is
            the (N, 2) array matplotlib hands every non-affine transform.
            """
            pts = _host(values)
            t_col, v_col = (1, 0) if self.transpose else (0, 1)
            t = pts[:, t_col]
            v = pts[:, v_col]

            # forward: bins-above-f0 -> Hz; inverse: Hz -> bins
            anchor = self.f0_interp(t)
            if self.is_inverted:
                mapped = (np.log2(v) - np.log2(anchor)) * (
                    self.norm * self.bins_per_octave
                )
            else:
                mapped = anchor * 2.0 ** (
                    v / self.norm / self.bins_per_octave
                )

            out = np.empty_like(pts)
            out[:, t_col] = t
            out[:, v_col] = mapped
            return out

        def inverted(self):
            """Return the inverse transform (matplotlib protocol).

            The inverse of the f0-displacement map is the same transform
            with ``is_inverted`` toggled: it converts absolute frequency
            back into the pitch-relative offset coordinate, which
            matplotlib needs for interactive cursors and autoscaling on
            axes that carry this transform.
            """
            state = {
                field: getattr(self, field)
                for field in ("f0", "sr", "hop_length", "bins_per_octave",
                              "norm", "offset", "transpose")
            }
            return Transformf0(is_inverted=not self.is_inverted, **state)

    return Transformf0


Transformf0 = _make_transformf0()


# ---------------------------------------------------------------------------
# Colormap inference (reference display.py:1291)
# ---------------------------------------------------------------------------


def infer_cmap(
    data: Any,
    *,
    robust: bool = True,
    cmap_seq: Any = "magma",
    cmap_bool: Any = "gray_r",
    cmap_div: Any = "coolwarm",
    div_thresh: float = 0.0,
) -> Any:
    """Data-driven colormap choice (sequential/diverging/boolean).

    Boolean data gets ``cmap_bool``; data straddling ``div_thresh`` gets
    ``cmap_div``; everything else gets ``cmap_seq``.  With ``robust``, the
    top and bottom 2% of values are discarded before the straddle test.

    Parity: display.py:1291 (infer_cmap).
    """
    import matplotlib as mpl
    from matplotlib import colors

    data = np.atleast_1d(_host(data))

    def _resolve(c):
        return c if isinstance(c, colors.Colormap) else mpl.colormaps[c]

    if data.dtype.kind == "b":
        return _resolve(cmap_bool)

    finite = data[np.isfinite(data)]
    limits = (2, 98) if robust else (0, 100)
    lo, hi = (
        np.percentile(finite, limits) if finite.size else (0.0, 0.0)
    )
    # one-signed data reads sequentially; sign-crossing data diverges
    one_signed = lo >= div_thresh or hi <= div_thresh
    return _resolve(cmap_seq if one_signed else cmap_div)


# Deprecation rename (reference display.py:1366): cmap -> infer_cmap.
cmap = infer_cmap


# Nominal center frequencies for 1/3-octave bands (reference display.py:129)
_OCT3_FREQUENCIES = np.array([
    31.5, 40, 50, 63, 80, 100, 125, 160, 200, 250, 315, 400, 500, 630, 800,
    1000, 1250, 1600, 2000, 2500, 3150, 4000, 5000, 6300, 8000, 10000,
    12500, 16000, 20000, 25000, 31500, 40000, 50000, 63000, 80000, 100000,
    125000, 160000, 200000, 250000, 315000, 400000, 500000, 630000, 800000,
])


# ---------------------------------------------------------------------------
# Coordinate grids (reference display.py:1947 __mesh_coords)
# ---------------------------------------------------------------------------


def _coords(
    axis_type: Optional[str],
    n: int,
    *,
    sr: float,
    hop_length: int,
    n_fft: Optional[int],
    fmin: Optional[float],
    fmax: Optional[float],
    bins_per_octave: int,
    win_length: Optional[int] = None,
    tempo_min: float = 16,
    intervals: Optional[Any] = None,
) -> np.ndarray:
    if axis_type is None or axis_type in ("off", "none"):
        return np.arange(n + 1)
    if axis_type in ("time", "s", "h", "m"):
        return convert.frames_to_time(
            np.arange(n + 1), sr=sr, hop_length=hop_length
        )
    if axis_type == "ms":
        return 1000 * convert.frames_to_time(
            np.arange(n + 1), sr=sr, hop_length=hop_length
        )
    if axis_type in ("lag", "lag_s", "lag_ms", "lag_h", "lag_m"):
        scale = 1000 if axis_type == "lag_ms" else 1
        return scale * convert.frames_to_time(
            np.arange(n + 1), sr=sr, hop_length=hop_length
        )
    if axis_type == "frames":
        return np.arange(n + 1)
    if axis_type in ("linear", "hz", "fft", "fft_note", "fft_svara", "log",
                     "oct3", "log_oct3"):
        return np.linspace(0, sr / 2, num=n + 1)
    if axis_type in ("mel", "mel_oct3"):
        f_max = fmax if fmax is not None else sr / 2
        f_min = fmin if fmin is not None else 0
        return convert.mel_frequencies(n + 1, fmin=f_min, fmax=f_max)
    if axis_type in ("cqt", "cqt_hz", "cqt_note", "cqt_svara", "cqt_oct3"):
        f_min = fmin if fmin is not None else float(convert.note_to_hz("C1"))
        return convert.cqt_frequencies(
            n + 1, fmin=f_min / 2.0 ** (0.5 / bins_per_octave),
            bins_per_octave=bins_per_octave,
        )
    if axis_type in ("vqt_hz", "vqt_note", "vqt_oct3", "vqt_fjs"):
        from .core.intervals import interval_frequencies

        f_min = fmin if fmin is not None else float(convert.note_to_hz("C1"))
        if intervals is None:
            # fall back to equal temperament
            return convert.cqt_frequencies(
                n + 1, fmin=f_min / 2.0 ** (0.5 / bins_per_octave),
                bins_per_octave=bins_per_octave,
            )
        return _host(interval_frequencies(
            n + 1, fmin=f_min, intervals=intervals,
            bins_per_octave=bins_per_octave,
        ))
    if axis_type in ("chroma", "chroma_h", "chroma_c", "chroma_fjs"):
        return np.linspace(0, 12, num=n + 1)
    if axis_type == "tempo":
        basis = convert.tempo_frequencies(n + 2, sr=sr, hop_length=hop_length)[1:]
        edges = np.arange(1, n + 2)
        return basis[edges - 1]
    if axis_type == "fourier_tempo":
        wl = win_length if win_length is not None else 2 * (n - 1)
        return convert.fourier_tempo_frequencies(
            sr=sr, win_length=wl + 2, hop_length=hop_length
        )[: n + 1]
    if axis_type == "tonnetz":
        return np.arange(n + 1)
    raise ParameterError(f"Unknown axis type: {axis_type}")


def _log_offset(f: float) -> float:
    """Position of ``f`` within its power-of-two octave (∈ [1, 2))."""
    e = np.log2(f)
    return float(2.0 ** (e - np.floor(e)))


def _decorate_axis(
    axis, ax_type: Optional[str], *, key: str = "C:maj",
    Sa: Optional[float] = None, mela: Optional[Any] = None,
    thaat: Optional[str] = None, unicode: bool = True,
    fmin: Optional[float] = None, intervals: Optional[Any] = None,
    unison: Optional[str] = None, bins_per_octave: int = 12,
    n_bins: Optional[int] = None,
) -> None:
    from matplotlib.ticker import (
        LogLocator, MaxNLocator, NullFormatter, ScalarFormatter,
        SymmetricalLogLocator, FixedLocator,
    )

    # Semitone grid within one octave, anchored at ``subs`` × 2^k
    def _semitone_minor(anchor: float) -> LogLocator:
        return LogLocator(
            base=2.0, subs=anchor * 2.0 ** (np.arange(1, 12) / 12.0)
        )

    _time_loc = MaxNLocator(prune=None, steps=[1, 1.5, 5, 6, 10])

    if ax_type in ("time", "lag"):
        axis.set_major_formatter(TimeFormatter(lag=(ax_type == "lag")))
        axis.set_major_locator(_time_loc)
        axis.set_label_text("Lag" if ax_type == "lag" else "Time")
    elif ax_type in ("s", "ms", "h", "m", "lag_s", "lag_ms", "lag_h", "lag_m"):
        lag = ax_type.startswith("lag")
        unit = ax_type[4:] if lag else ax_type
        axis.set_major_formatter(TimeFormatter(lag=lag, unit=unit))
        axis.set_major_locator(_time_loc)
        label_unit = {"h": "h:m:s", "m": "m:s"}.get(unit, unit)
        axis.set_label_text(
            ("Lag" if lag else "Time") + f" ({label_unit})"
        )
    elif ax_type == "frames":
        axis.set_label_text("Frames")
    elif ax_type in ("linear", "hz", "fft"):
        axis.set_major_formatter(ScalarFormatter())
        axis.set_label_text("Hz")
    elif ax_type in ("log", "mel"):
        axis.set_major_formatter(ScalarFormatter())
        axis.set_major_locator(SymmetricalLogLocator(axis.get_transform()))
        axis.set_label_text("Hz")
    elif ax_type in ("cqt_hz",):
        c_off = _log_offset(convert.note_to_hz("C1"))
        axis.set_major_formatter(LogHzFormatter())
        axis.set_major_locator(LogLocator(base=2.0))
        axis.set_minor_formatter(LogHzFormatter(major=False))
        axis.set_minor_locator(_semitone_minor(c_off))
        axis.set_label_text("Hz")
    elif ax_type in ("cqt", "cqt_note"):
        c_off = _log_offset(convert.note_to_hz("C1"))
        axis.set_major_formatter(NoteFormatter(key=key, unicode=unicode))
        axis.set_major_locator(LogLocator(base=2.0, subs=(c_off,)))
        axis.set_minor_formatter(
            NoteFormatter(key=key, major=False, unicode=unicode)
        )
        axis.set_minor_locator(_semitone_minor(c_off))
        axis.set_label_text("Note")
    elif ax_type == "fft_note":
        axis.set_major_formatter(NoteFormatter(key=key, unicode=unicode))
        axis.set_major_locator(SymmetricalLogLocator(axis.get_transform()))
        axis.set_minor_formatter(
            NoteFormatter(key=key, major=False, unicode=unicode)
        )
        axis.set_minor_locator(_semitone_minor(1.0))
        axis.set_label_text("Note")
    elif ax_type in ("cqt_svara", "fft_svara"):
        sa_off = _log_offset(Sa) if Sa else 1.0
        axis.set_major_formatter(SvaraFormatter(Sa, mela=mela, unicode=unicode))
        if ax_type == "fft_svara":
            axis.set_major_locator(
                SymmetricalLogLocator(
                    axis.get_transform(), base=2.0, subs=[sa_off]
                )
            )
        else:
            axis.set_major_locator(LogLocator(base=2.0, subs=(sa_off,)))
        axis.set_minor_formatter(
            SvaraFormatter(Sa, mela=mela, major=False, unicode=unicode)
        )
        axis.set_minor_locator(_semitone_minor(sa_off))
        axis.set_label_text("Svara")
    elif ax_type == "vqt_fjs":
        f0 = fmin if fmin else float(convert.note_to_hz("C1"))
        ivals = intervals if intervals is not None else "equal"
        axis.set_major_formatter(
            FJSFormatter(
                fmin=f0, unison=unison, unicode=unicode, intervals=ivals,
                n_bins=n_bins, bins_per_octave=bins_per_octave,
            )
        )
        f_off = _log_offset(f0)
        axis.set_major_locator(LogLocator(base=2.0, subs=(f_off,)))
        axis.set_minor_formatter(
            FJSFormatter(
                fmin=f0, unison=unison, unicode=unicode, intervals=ivals,
                n_bins=n_bins, bins_per_octave=bins_per_octave, major=False,
            )
        )
        if n_bins is not None:
            from .core.intervals import interval_frequencies

            axis.set_minor_locator(
                FixedLocator(
                    _host(
                        interval_frequencies(
                            n_bins * 12 // bins_per_octave, fmin=f0,
                            intervals=ivals, bins_per_octave=12,
                        )
                    )
                )
            )
        axis.set_label_text("Note (FJS)")
    elif ax_type in ("vqt_hz",):
        f0 = fmin if fmin else float(convert.note_to_hz("C1"))
        f_off = _log_offset(f0)
        axis.set_major_formatter(LogHzFormatter())
        axis.set_major_locator(LogLocator(base=2.0, subs=(f_off,)))
        axis.set_minor_formatter(LogHzFormatter(major=False))
        axis.set_minor_locator(_semitone_minor(f_off))
        axis.set_label_text("Hz")
    elif ax_type in ("vqt_note",):
        f0 = fmin if fmin else float(convert.note_to_hz("C1"))
        f_off = _log_offset(f0)
        axis.set_major_formatter(NoteFormatter(key=key, unicode=unicode))
        axis.set_major_locator(LogLocator(base=2.0, subs=(f_off,)))
        axis.set_minor_formatter(
            NoteFormatter(key=key, major=False, unicode=unicode)
        )
        axis.set_minor_locator(_semitone_minor(f_off))
        axis.set_label_text("Note")
    elif ax_type in ("oct3", "cqt_oct3", "vqt_oct3", "log_oct3", "mel_oct3"):
        # label once per octave; minor ticks at the 1/3 octaves fade out
        # when the view is wider than two octaves
        if ax_type == "mel_oct3":
            axis.set_major_locator(FixedLocator(_OCT3_FREQUENCIES[5::3]))
        else:
            axis.set_major_locator(FixedLocator(_OCT3_FREQUENCIES[::3]))
        axis.set_major_formatter(AdaptiveEngFormatter(major=True, unit="Hz"))
        axis.set_minor_locator(FixedLocator(_OCT3_FREQUENCIES))
        axis.set_minor_formatter(AdaptiveEngFormatter(major=False, unit="Hz"))
        axis.set_label_text("Frequency")
    elif ax_type == "chroma_fjs":
        from matplotlib.ticker import FixedLocator

        axis.set_major_formatter(
            ChromaFJSFormatter(
                intervals=intervals if intervals is not None else "equal",
                unison=unison if unison is not None else "C",
                unicode=unicode,
                bins_per_octave=bins_per_octave,
            )
        )
        axis.set_major_locator(
            FixedLocator(0.5 + np.arange(bins_per_octave))
        )
        axis.set_label_text("Pitch class")
    elif ax_type == "chroma":
        axis.set_major_formatter(ChromaFormatter(key=key, unicode=unicode))
        axis.set_major_locator(FixedLocator(0.5 + np.arange(12)))
        axis.set_label_text("Pitch class")
    elif ax_type in ("chroma_h", "chroma_c"):
        axis.set_major_formatter(
            ChromaSvaraFormatter(Sa=Sa, mela=mela, unicode=unicode)
        )
        axis.set_major_locator(FixedLocator(0.5 + np.arange(12)))
        axis.set_label_text("Svara")
    elif ax_type in ("tempo", "fourier_tempo"):
        axis.set_major_formatter(ScalarFormatter())
        axis.set_major_locator(LogLocator(base=2.0))
        axis.set_label_text("BPM")
    elif ax_type == "tonnetz":
        axis.set_major_formatter(TonnetzFormatter())
        axis.set_major_locator(FixedLocator(0.5 + np.arange(6)))
        axis.set_label_text("Tonnetz")
    elif ax_type in (None, "off", "none"):
        axis.set_label_text("")
        axis.set_ticks([])


_LOG_SCALED = {"log", "cqt", "cqt_hz", "cqt_note", "cqt_svara", "cqt_oct3",
               "vqt_hz", "vqt_note", "vqt_oct3", "vqt_fjs",
               "log_oct3", "oct3", "mel", "mel_oct3",
               "fft_note", "fft_svara",
               "tempo", "fourier_tempo"}

# vscale grammar (reference display.py:2625): dBFS | dB, optional
# [power], [ref], or [power,ref] suffix.
import re as _re

_VSCALE_PATTERN = _re.compile(
    r"^(?P<mode>dBFS|dB)"
    r"(?:\[(?:(?P<type>power)"
    r"(?:,(?P<ref_power>[+-]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?))?"
    r"|(?P<ref>[+-]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?))\])?$"
)


def _parse_vscale(vscale: str):
    """'dBFS' → ('dBFS','amplitude','max'); 'dB[power,0.1]' → ('dB','power',0.1).

    Parity: display.py:2633 (__parse_vscale).
    """
    parsed = _VSCALE_PATTERN.fullmatch(vscale)
    if parsed is None:
        raise ParameterError(f"cannot parse vscale specification {vscale!r}")
    fields = parsed.groupdict()
    kind = "power" if fields.get("type") else "amplitude"
    anchor = fields.get("ref") or fields.get("ref_power")
    if fields["mode"] == "dBFS":
        # full-scale mode pins the reference to the signal maximum
        if anchor is not None:
            raise ParameterError(
                "dBFS is always referenced to full scale; drop the "
                "explicit reference value"
            )
        return fields["mode"], kind, "max"
    return fields["mode"], kind, None if anchor is None else float(anchor)


def _scale_data(data, *, vscale, top_db, x_coords, y_coords, cmap_seq,
                cmap_cyclic):
    """Apply the vscale transform; return (data, cmap-or-None).

    Parity: display.py:2544 (__scale_data) — phase/dphase/dphase_t use the
    cyclic colormap; dB modes use power/amplitude_to_db with the requested
    reference and the sequential colormap.
    """
    if vscale is None:
        return data, None

    if vscale == "phase":
        return np.angle(data), cmap_cyclic

    if vscale == "dphase":
        diff = np.diff(np.unwrap(np.angle(data), axis=-1), axis=-1, prepend=0.0)
        diff -= np.multiply.outer(
            2 * np.pi * y_coords[: data.shape[0]],
            np.diff(x_coords[: data.shape[1]], prepend=0.0),
        )
        diff += np.pi
        np.mod(diff, 2 * np.pi, out=diff)
        diff -= np.pi
        return diff, cmap_cyclic

    if vscale == "dphase_t":
        diff = np.diff(np.unwrap(np.angle(data), axis=0), axis=0, prepend=0.0)
        diff -= np.multiply.outer(
            np.diff(y_coords[: data.shape[0]], prepend=0.0),
            2 * np.pi * x_coords[: data.shape[1]],
        )
        diff += np.pi
        np.mod(diff, 2 * np.pi, out=diff)
        diff -= np.pi
        return diff, cmap_cyclic

    _mode, scale_type, ref_ = _parse_vscale(vscale)
    if ref_ == "max":
        ref = float(np.max(np.abs(data)))
    elif ref_ is None:
        ref = 1.0
    else:
        ref = float(ref_)

    if scale_type == "power":
        data = _host(core.power_to_db(np.abs(data), top_db=top_db, ref=ref))
    else:
        data = _host(
            core.amplitude_to_db(np.abs(data), top_db=top_db, ref=ref)
        )
    return data, cmap_seq


def specshow(
    data: Any,
    *,
    x_coords: Optional[np.ndarray] = None,
    y_coords: Optional[np.ndarray] = None,
    x_axis: Optional[str] = None,
    y_axis: Optional[str] = None,
    vscale: Optional[str] = None,
    sr: float = 22050,
    hop_length: int = 512,
    n_fft: Optional[int] = None,
    win_length: Optional[int] = None,
    fmin: Optional[float] = None,
    fmax: Optional[float] = None,
    tempo_min: Optional[float] = 16,
    tempo_max: Optional[float] = 480,
    tuning: float = 0.0,
    bins_per_octave: int = 12,
    key: str = "C:maj",
    Sa: Optional[float] = None,
    mela: Optional[Any] = None,
    thaat: Optional[str] = None,
    auto_aspect: bool = True,
    htk: bool = False,
    unicode: bool = True,
    intervals: Optional[Any] = None,
    unison: Optional[str] = None,
    top_db: Optional[float] = 80.0,
    cmap_seq: Any = "magma",
    cmap_bool: Any = "gray_r",
    cmap_div: Any = "coolwarm",
    cmap_cyclic: Any = "twilight_shifted",
    div_thresh: float = 0.0,
    ax: Optional[Any] = None,
    **kwargs: Any,
):
    """Display a spectrogram/chromagram/cqt/etc. Parity: display.py:1441.

    ``vscale`` applies a value transform before display: ``'dBFS'`` /
    ``'dB'`` (optionally ``[power]`` / ``[ref]``) for decibel scaling,
    ``'phase'`` / ``'dphase'`` / ``'dphase_t'`` for phase displays with a
    cyclic colormap.  Returns the QuadMesh artist.
    """
    plt = _mpl()
    import matplotlib as mpl
    from matplotlib import colors

    data = np.atleast_2d(_host(data))

    all_params = dict(
        sr=sr, hop_length=hop_length, n_fft=n_fft, fmin=fmin, fmax=fmax,
        bins_per_octave=bins_per_octave, win_length=win_length,
        intervals=intervals,
    )

    if y_coords is None:
        y_coords = _coords(y_axis, data.shape[0], **all_params)[: data.shape[0] + 1]
    if x_coords is None:
        x_coords = _coords(x_axis, data.shape[1], **all_params)[: data.shape[1] + 1]

    data, norm_cmap = _scale_data(
        data, vscale=vscale, top_db=top_db, x_coords=_host(x_coords),
        y_coords=_host(y_coords), cmap_seq=cmap_seq,
        cmap_cyclic=cmap_cyclic,
    )

    if np.issubdtype(data.dtype, np.complexfloating):
        import warnings

        warnings.warn(
            "specshow has no rendering for complex values; drawing the "
            "magnitude instead",
            stacklevel=2,
        )
        data = np.abs(data)

    if norm_cmap is not None:
        kwargs.setdefault("cmap", norm_cmap)
    elif "cmap" not in kwargs:
        # auto-pick a map from the data, and a matching norm: diverging
        # maps center on the threshold, boolean maps snap to two colors
        chosen = infer_cmap(
            data, cmap_seq=cmap_seq, cmap_bool=cmap_bool, cmap_div=cmap_div,
            div_thresh=div_thresh,
        )
        kwargs["cmap"] = chosen

        def _picked(candidate):
            if not isinstance(candidate, colors.Colormap):
                candidate = mpl.colormaps.get(candidate, None)
            return chosen == candidate

        if _picked(cmap_div) and "norm" not in kwargs:
            kwargs["norm"] = colors.TwoSlopeNorm(
                vcenter=div_thresh,
                vmin=kwargs.pop("vmin", None),
                vmax=kwargs.pop("vmax", None),
            )
        elif (
            _picked(cmap_bool) and data.dtype.kind == "b"
            and "norm" not in kwargs
        ):
            kwargs["norm"] = colors.BoundaryNorm(
                boundaries=[0, 0.5, 1], ncolors=chosen.N
            )

    mesh_defaults = {"rasterized": True, "edgecolors": "None",
                     "shading": "auto"}
    if vscale is not None and "phase" in vscale:
        mesh_defaults.update(vmin=-np.pi, vmax=np.pi)
    for option, value in mesh_defaults.items():
        kwargs.setdefault(option, value)

    if ax is None:
        ax = plt.gca()

    out = ax.pcolormesh(x_coords[: data.shape[1]], y_coords[: data.shape[0]],
                        data, **kwargs)

    # set limits
    ax.set_xlim(x_coords.min(), x_coords.max())
    ax.set_ylim(y_coords.min(), y_coords.max())

    # scaling; tempo axes clip to [tempo_min, tempo_max] (display.py:2015)
    if y_axis in ("tempo", "fourier_tempo"):
        ax.set_yscale("log", base=2)
        if tempo_min is not None or tempo_max is not None:
            ax.set_ylim(tempo_min, tempo_max)
    elif y_axis in _LOG_SCALED:
        pos = y_coords[y_coords > 0]
        if len(pos):
            ax.set_yscale("symlog", linthresh=float(pos.min()), base=2)
    if x_axis in ("tempo", "fourier_tempo"):
        ax.set_xscale("log", base=2)
        if tempo_min is not None or tempo_max is not None:
            ax.set_xlim(tempo_min, tempo_max)
    elif x_axis in _LOG_SCALED:
        pos = x_coords[x_coords > 0]
        if len(pos):
            ax.set_xscale("symlog", linthresh=float(pos.min()), base=2)

    _decorate_axis(
        ax.yaxis, y_axis, key=key, Sa=Sa, mela=mela, thaat=thaat,
        unicode=unicode, fmin=fmin, intervals=intervals, unison=unison,
        bins_per_octave=bins_per_octave, n_bins=data.shape[0],
    )
    _decorate_axis(
        ax.xaxis, x_axis, key=key, Sa=Sa, mela=mela, thaat=thaat,
        unicode=unicode, fmin=fmin, intervals=intervals, unison=unison,
        bins_per_octave=bins_per_octave, n_bins=data.shape[1],
    )

    return out

def _envelope(x: np.ndarray, hop: int) -> np.ndarray:
    """Max-envelope of non-overlapping hop-length frames of (ch, n) audio.

    Parity: display.py:1371 (__envelope).
    """
    n = x.shape[-1] // hop
    if n == 0:
        return np.zeros(x.shape[:-1] + (0,), dtype=x.dtype)
    return np.abs(x[..., : n * hop]).reshape(x.shape[:-1] + (n, hop)).max(
        axis=-1
    )


def waveshow(
    y: Any,
    *,
    sr: float = 22050,
    max_points: int = 11025,
    axis: Optional[str] = "time",
    offset: float = 0.0,
    marker: Any = "",
    where: str = "post",
    label: Optional[str] = None,
    transpose: bool = False,
    mask: Optional[Any] = None,
    ax: Optional[Any] = None,
    invert: bool = False,
    invert_color: Optional[Any] = None,
    **kwargs: Any,
) -> "AdaptiveWaveplot":
    """Adaptive waveform display: envelope zoomed out, samples zoomed in.

    Draws both a max-envelope fill (wide views) and a sample-level step
    plot (narrow views) and returns the :class:`AdaptiveWaveplot` that
    switches between them on every x-limit change.

    Parameters
    ----------
    y : np.ndarray [shape=(n,) or (ch, n)]
        audio signal
    sr : number > 0
        sampling rate
    max_points : int
        zoom threshold: sample view below this many visible samples
    axis : str or None
        x-axis type (e.g. ``'time'``)
    offset : float
        starting time of the signal
    mask : np.ndarray or None
        per-sample visibility for the sample view
    invert : bool
        swap foreground/background colors
    transform : matplotlib transform or None
        data transform (used by :func:`wavef0`)
    ax : matplotlib axes or None
        target axes
    **kwargs
        forwarded to the line/fill artists

    Returns
    -------
    adaptor : AdaptiveWaveplot
        the connected envelope/sample switcher

    Parity: reference display.py:2673.
    """
    plt = _mpl()
    y = _waveform_display_input(y)
    if max_points <= 0:
        raise ParameterError(
            f"max_points must allow at least one sample; got {max_points}"
        )
    axes = plt.gca() if ax is None else ax

    # amplitude envelope on a decimated grid sized to max_points
    stride = max(1, y.shape[-1] // max_points)
    env = _envelope(y, stride)
    decimated = slice(None, len(env[0]) * stride, stride)
    times = offset + np.arange(y.shape[-1]) / sr

    filler, limit_signal, labeled_axis = _plane_orientation(axes, transpose)
    detail = (times[:max_points], y[0, :max_points])
    if transpose:
        detail = detail[::-1]

    if mask is not None:
        mask = _host(mask, dtype=bool)[decimated]

    # zoomed-in view: the per-sample step curve
    (steps,) = axes.step(*detail, marker=marker, where=where, **kwargs)
    if "color" not in kwargs:
        kwargs.setdefault("color", steps.get_color())

    # zoomed-out view: the filled +/- envelope band (the legend entry
    # rides the AdaptiveWaveplot's label proxy, not this artist)
    band = filler(
        times[decimated], -env[-1], env[0],
        step=where, where=mask, **kwargs,
    )

    adaptor = AdaptiveWaveplot(
        times, y[0], steps, band, sr=sr, max_samples=max_points,
        transpose=transpose, label=label,
    )
    adaptor.connect(axes, signal=limit_signal)
    adaptor.update(axes)

    if invert:
        _swap_ink(axes, steps.get_color(), (steps, band), invert_color)
    _decorate_axis(labeled_axis, axis)
    return adaptor


def _waveform_display_input(y: np.ndarray) -> np.ndarray:
    """Validate + shape a signal for waveform display: float dtype,
    (channels, n) layout, >2-D stacks downmixed to mono."""
    y = _host(y)
    if not np.issubdtype(y.dtype, np.floating):
        raise ParameterError(
            "waveform displays need floating-point samples"
        )
    if y.ndim > 2:
        y = _host(core.to_mono(y))
    return np.atleast_2d(y)


def _plane_orientation(axes, transpose: bool):
    """(fill function, limit-change signal, time axis) for an orientation."""
    if transpose:
        return axes.fill_betweenx, "ylim_changed", axes.yaxis
    return axes.fill_between, "xlim_changed", axes.xaxis


def _swap_ink(axes, ink, artists, background=None):
    """Invert a waveform plot: paint the axes patch with the waveform's
    color and the waveform artists with the (old) background color."""
    if background is None:
        background = axes.patch.get_facecolor()
    axes.patch.set_facecolor(ink)
    for artist in artists:
        artist.set_color(background)


def wavebars(
    y: Any,
    *,
    sr: float = 22050,
    n_bars: int = 100,
    gap_ratio: float = 0.4,
    rounding_ratio: float = 0.5,
    axis: Optional[str] = "time",
    offset: float = 0.0,
    invert: bool = False,
    invert_color: Optional[Any] = None,
    transpose: bool = False,
    label: Optional[str] = None,
    ax: Optional[Any] = None,
    **patch_kwargs: Any,
):
    """Rounded-bar amplitude envelope ("soundbars") display.

    Renders ``n_bars`` FancyBboxPatch bars of width
    ``(hop/sr)·(1-gap_ratio)`` with corner rounding ``rounding_ratio``,
    each spanning the per-bar max envelope — top channel up, bottom
    channel down for stereo input.

    Parameters
    ----------
    y : np.ndarray [shape=(n,) or (2, n)]
        audio signal
    sr : number > 0
        sampling rate
    n_bars : int or None
        number of bars (None: derive from hop)
    ax : matplotlib axes or None
        target axes
    **kwargs
        forwarded to the patch collection (e.g. ``color``)

    Returns
    -------
    collection : matplotlib.collections.PatchCollection
        the rendered bars

    Parity: reference display.py:2992.
    """
    plt = _mpl()
    import matplotlib.collections as mcollections
    import matplotlib.patches as mpatches

    y = _waveform_display_input(y)
    patch_kwargs.setdefault("linewidth", 0)
    axes = plt.gca() if ax is None else ax

    # one rounded bar per envelope cell
    stride = max(1, y.shape[-1] // n_bars)
    env = _envelope(y, stride)
    centers = offset + np.arange(env.shape[-1]) * stride / sr

    thickness = (stride / sr) * (1 - gap_ratio)
    corner = thickness * rounding_ratio
    corner_style = f"round,pad=0,rounding_size={corner}"

    def _bar(at, lo, hi):
        # every bar spans at least the corner radius on both sides
        foot = min(-corner, -lo)
        head = max(corner, hi)
        if transpose:
            return mpatches.FancyBboxPatch(
                (foot, at), head - foot, thickness, boxstyle=corner_style
            )
        return mpatches.FancyBboxPatch(
            (at, foot), thickness, head - foot, boxstyle=corner_style
        )

    bars = [
        _bar(at, lo, hi) for at, lo, hi in zip(centers, env[-1], env[0])
    ]
    patch_kwargs.setdefault("transform", axes.transData)
    bar_group = mcollections.PatchCollection(bars, **patch_kwargs)
    axes.add_collection(bar_group)

    # an off-canvas proxy patch carries the legend entry (collections
    # don't legend individually)
    proxy = mpatches.FancyBboxPatch(
        (np.nan, np.nan), 1, 1, boxstyle=corner_style, label=label,
        **patch_kwargs,
    )
    proxy.set_in_layout(False)
    if label is not None:
        axes.add_patch(proxy)
    axes.autoscale_view()

    if invert:
        ink = bar_group.get_facecolor()
        proxy.set_facecolor(ink)
        _swap_ink(axes, ink, (bar_group,), invert_color)

    _decorate_axis(axes.yaxis if transpose else axes.xaxis, axis)
    return bar_group


def wavef0(
    y: Any,
    *,
    f0: Any,
    sr: float = 22050,
    hop_length: int = 512,
    bins_per_octave: int = 12,
    time_axis: str = "time",
    freq_axis: str = "cqt_note",
    offset: float = 0.0,
    key: str = "C:maj",
    Sa: Optional[float] = None,
    mela: Optional[Any] = None,
    thaat: Optional[str] = None,
    unicode: bool = True,
    ax: Optional[Any] = None,
    method: str = "waveshow",
    transpose: bool = False,
    **kwargs: Any,
):
    """Waveform display displaced along an f0 contour.

    The waveform rides its fundamental frequency on a log-frequency
    axis via the :class:`Transformf0` data transform; unvoiced (NaN)
    regions are masked out.

    Parameters
    ----------
    y : np.ndarray
        audio signal
    f0 : np.ndarray
        frame-rate fundamental frequency contour (NaN = unvoiced)
    sr : number > 0
        sampling rate
    hop_length : int > 0
        hop of the f0 contour
    method : {'waveshow', 'wavebars'}
        rendering backend
    freq_axis : str
        frequency-axis decoration type
    transpose : bool
        put time on the y axis
    ax : matplotlib axes or None
        target axes
    **kwargs
        forwarded to the rendering backend

    Returns
    -------
    artists
        whatever the selected backend returns

    Parity: reference display.py:3176.
    """
    plt = _mpl()
    import matplotlib.lines as mlines

    from .util import utils as _util

    if method not in ("waveshow", "wavebars"):
        raise ParameterError(
            f"wavef0 draws via waveshow or wavebars; got method={method!r}"
        )
    y = _host(y)
    f0 = _host(f0, dtype=float)
    axes = plt.gca() if ax is None else ax

    # normalize the waveform's amplitude span so +/-1 maps to one
    # pitch-axis unit under the f0-anchored log-frequency transform
    span = float(_host(_util.tiny(y)))
    if y.size > 0:
        span += max(float(y.max()), -float(y.min()))
    pitch_warp = Transformf0(
        f0, sr=sr, hop_length=hop_length, bins_per_octave=bins_per_octave,
        norm=span, offset=offset, transpose=transpose,
    )

    _decorate_axis(
        axes.xaxis if transpose else axes.yaxis, freq_axis, key=key, Sa=Sa,
        mela=mela, thaat=thaat, unicode=unicode,
    )

    if method == "wavebars":
        return wavebars(
            y, sr=sr, axis=time_axis, offset=offset, ax=axes,
            transform=pitch_warp + axes.transData, transpose=transpose,
            **kwargs,
        )

    # waveshow path: blank out unvoiced spans, then widen the view to
    # cover the full f0 range via a throwaway guide line
    ticks = offset + np.arange(y.shape[-1]) / sr
    voiced = np.isfinite(pitch_warp.f0_interp(ticks))
    adaptor = waveshow(
        y, sr=sr, axis=time_axis, offset=offset, mask=voiced, ax=axes,
        transform=pitch_warp + axes.transData, transpose=transpose, **kwargs,
    )

    corners = adaptor.envelope.get_datalim(
        pitch_warp + axes.transData
    ).get_points()
    lo, hi = np.nanmin(f0), np.nanmax(f0)
    if transpose:
        guide = mlines.Line2D(
            [corners[0, 0] + lo, corners[1, 0] + hi], corners[:, 1]
        )
    else:
        guide = mlines.Line2D(
            corners[:, 0], [corners[0, 1] + lo, corners[1, 1] + hi]
        )
    axes.add_line(guide)
    axes.autoscale_view()
    guide.remove()
    return adaptor


def _radian_formatter(x: float, pos: Optional[int] = None) -> str:
    """Format a radian tick as a signed rational multiple of π.

    Snaps ``x/π`` to the nearest fraction with denominator ≤ 16 by
    scanning candidate denominators (smallest denominator wins ties up
    to float noise), then renders ``±[p]π[/q]`` with the unit
    coefficient elided — e.g. `` π/2``, ``-3π/4``, `` 0``, `` 2π``.
    Output grammar matches the reference phase labels (display.py:3440).
    """
    import math

    turns = x / np.pi
    best = (abs(turns - round(turns)), 1, int(round(turns)))
    for q in range(2, 17):
        p = int(round(turns * q))
        err = abs(turns - p / q)
        if err < best[0] - 1e-12:
            best = (err, q, p)
    _, q, p = best
    if p == 0:
        return " 0"
    shared = math.gcd(abs(p), q)
    p, q = p // shared, q // shared
    head = "-" if p < 0 else " "
    if abs(p) != 1:
        head += str(abs(p))
    return f"{head}π" if q == 1 else f"{head}π/{q}"


def colorbar_phase(
    im: Any,
    *,
    numticks: int = 9,
    ax: Optional[Any] = None,
    fig: Optional[Any] = None,
    **kwargs: Any,
):
    """Attach a colorbar whose ticks read as rational multiples of π.

    Intended for phase images (``specshow(..., vscale='phase')`` or raw
    ``np.angle`` data): the [-π, π] range labels as ``-π, -π/2, 0, ...``.

    Parameters
    ----------
    im : matplotlib artist
        the mappable to describe (e.g. a specshow QuadMesh)
    numticks : int
        number of evenly spaced ticks
    ax : matplotlib axes or None
        axes to steal space from
    fig : matplotlib figure or None
        figure to draw into
    **kwargs
        forwarded to ``figure.colorbar``

    Returns
    -------
    colorbar : matplotlib.colorbar.Colorbar
        the created colorbar

    Parity: reference display.py:3461.
    """
    plt = _mpl()
    from matplotlib.ticker import FuncFormatter, LinearLocator

    if fig is None:
        fig = plt.gcf() if ax is None else None
    kwargs.setdefault("format", FuncFormatter(_radian_formatter))
    kwargs.setdefault("ticks", LinearLocator(numticks=numticks))
    if fig is not None:
        return fig.colorbar(im, ax=ax, **kwargs)
    return plt.colorbar(im, ax=ax, **kwargs)


def colorbar_db(
    im: Any,
    *,
    ax: Optional[Any] = None,
    fig: Optional[Any] = None,
    format: Any = "% -3.f",
    **kwargs: Any,
):
    """Attach a colorbar formatted for decibel data.

    Ticks render with the given format (``'%+2.0f dB'`` by default),
    matching the reference's convention for ``power_to_db`` images.

    Parameters
    ----------
    im : matplotlib artist
        the mappable to describe
    format : str
        tick label format
    ax : matplotlib axes or None
        axes to steal space from
    fig : matplotlib figure or None
        figure to draw into
    **kwargs
        forwarded to ``figure.colorbar``

    Returns
    -------
    colorbar : matplotlib.colorbar.Colorbar
        the created colorbar

    Parity: reference display.py:3544.
    """
    plt = _mpl()
    kwargs.setdefault("format", format)
    if fig is None and ax is None:
        fig = plt.gcf()
    if fig is not None:
        return fig.colorbar(im, ax=ax, **kwargs)
    return plt.colorbar(im, ax=ax, **kwargs)


_MULTIPLOT_FUNCS = {
    # name → (function getter, per-datum dims, props that don't apply)
    "waveshow": (lambda: waveshow, 1, ()),
    "wavebars": (lambda: wavebars, 1, ()),
    "specshow": (lambda: specshow, 2, ("color", "linestyle", "marker")),
}


def multiplot(
    func: str,
    *data: Any,
    axes: Optional[Any] = None,
    fig: Optional[Any] = None,
    orient: str = "v",
    share_properties: Optional[Any] = None,
    fig_kw: Optional[dict] = None,
    sharex: bool = True,
    sharey: bool = True,
    label_outer: bool = True,
    labels: Optional[Sequence[Optional[str]]] = None,
    titles: Optional[Sequence[Optional[str]]] = None,
    prop_cycle: Optional[Any] = None,
    **kwargs: Any,
):
    """Display multiple signals/spectrograms on a synchronized grid.

    Parity: display.py:3939 — ``func`` names the display function
    (``'waveshow'``, ``'wavebars'``, or ``'specshow'``); data may be
    variadic (one array per subplot) or a single stacked array whose
    leading dims index subplots.  Returns an object array of artists
    shaped like the axes grid.
    """
    plt = _mpl()

    if func not in _MULTIPLOT_FUNCS:
        raise ParameterError(
            f"Invalid multiplot function={func}; expected one of "
            f"{sorted(_MULTIPLOT_FUNCS)}"
        )
    getter, dims, badprops = _MULTIPLOT_FUNCS[func]
    function = getter()

    if len(data) == 0:
        raise ParameterError("multiplot requires at least one data input")

    # Layout: variadic inputs → one subplot each; a single stacked array →
    # leading (ndim - dims) axes index the grid.
    if len(data) > 1:
        multi_input = True
        axshape: tuple = (len(data),)
    else:
        d0 = _host(data[0])
        lead = d0.ndim - dims
        if lead <= 0:
            multi_input = True
            axshape = (1,)
        else:
            multi_input = False
            axshape = d0.shape[:lead]

    if len(axshape) == 1:
        nrows, ncols = (
            (axshape[0], 1) if orient == "v" else (1, axshape[0])
        )
    elif len(axshape) == 2:
        nrows, ncols = axshape
        if orient == "h":
            nrows, ncols = ncols, nrows
    else:
        raise ParameterError(
            f"multiplot supports at most 2 leading grid dims, got {axshape}"
        )

    if axes is None:
        fig_kw = dict(fig_kw or {})
        fig_kw.setdefault("squeeze", False)
        if fig is None:
            fig, axarr = plt.subplots(
                nrows=nrows, ncols=ncols, sharex=sharex, sharey=sharey,
                **fig_kw,
            )
        else:
            axarr = fig.subplots(
                nrows=nrows, ncols=ncols, sharex=sharex, sharey=sharey,
                **fig_kw,
            )
        axes = _host(axarr, dtype=object)
    else:
        axes = np.atleast_1d(_host(axes, dtype=object))

    n_plots = int(np.prod(axshape))
    if axes.size < n_plots:
        raise ParameterError(
            f"Provided axes (size {axes.size}) are incompatible with "
            f"data layout {axshape}"
        )

    def _labels_array(seq):
        out = np.full(n_plots, None, dtype=object)
        if seq is not None:
            for i, s in enumerate(seq[:n_plots]):
                out[i] = s
        return out

    labels_arr = _labels_array(labels)
    titles_arr = _labels_array(titles)

    # Property cycling: each subplot (or property group) takes the next
    # entry of the prop cycle, minus properties the function can't use.
    if prop_cycle is None:
        prop_cycle = plt.rcParams["axes.prop_cycle"]
    cycle_iter = iter(prop_cycle)

    if share_properties in (None, False):
        group_of = list(range(n_plots))
    elif share_properties is True:
        group_of = [0] * n_plots
    elif share_properties in ("row", "col"):
        grid = np.arange(n_plots).reshape(axshape if len(axshape) == 2
                                          else (n_plots, 1))
        if share_properties == "row":
            group_of = list(np.repeat(np.arange(grid.shape[0]),
                                      grid.shape[1]))
        else:
            group_of = list(np.tile(np.arange(grid.shape[1]),
                                    grid.shape[0]))
    else:
        group_of = list(_host(share_properties).reshape(-1)[:n_plots])

    group_props: dict = {}
    output = np.empty(n_plots, dtype=object)
    for flat_idx in range(n_plots):
        g = group_of[flat_idx]
        if g not in group_props:
            try:
                props = dict(next(cycle_iter))
            except StopIteration:
                props = {}
            group_props[g] = {
                k: v for k, v in props.items() if k not in badprops
            }
        axx = axes.flat[flat_idx]
        if multi_input:
            datum = _host(data[flat_idx]) if len(data) > 1 else _host(data[0])
        else:
            datum = _host(data[0]).reshape((-1,) + _host(data[0]).shape[-dims:])[flat_idx]
        call_kw = dict(group_props[g])
        call_kw.update(kwargs)
        if func != "specshow" and labels_arr[flat_idx] is not None:
            call_kw["label"] = labels_arr[flat_idx]
        output[flat_idx] = function(datum, ax=axx, **call_kw)
        if titles_arr[flat_idx] is not None:
            axx.set_title(titles_arr[flat_idx])
        if label_outer and hasattr(axx, "label_outer"):
            axx.label_outer()

    return output.reshape(axes.shape if axes.size == n_plots else (n_plots,))


def legend_for_axes(
    axes: Optional[Any] = None,
    *,
    fig: Optional[Any] = None,
    **kwargs: Any,
):
    """Aggregate labeled artists from several axes into one legend.

    Collects every artist with a label from the given axes (or all of a
    figure's axes) and attaches a single combined legend — useful for
    ``multiplot`` grids where per-axes legends would repeat.

    Parameters
    ----------
    axes : matplotlib axes, iterable of axes, or None
        axes to harvest labels from (None: every axes in ``fig``)
    fig : matplotlib figure or None
        target figure (default: the axes' figure or current figure)
    **kwargs
        forwarded to ``figure.legend``

    Returns
    -------
    legend : matplotlib.legend.Legend
        the combined legend

    Parity: reference display.py:4122.
    """
    plt = _mpl()

    if axes is None:
        fig = fig if fig is not None else plt.gcf()
        axes = fig.axes
    pool = list(np.atleast_1d(_host(axes, dtype=object)).flat)
    if not pool:
        raise ParameterError("there are no axes to aggregate a legend from")

    owner = fig if fig is not None else pool[0].figure
    if any(a.figure is not owner for a in pool):
        raise ParameterError(
            "legend aggregation needs every axis on one figure"
        )

    per_axis = [a.get_legend_handles_labels() for a in pool]
    handles = [h for hs, _ in per_axis for h in hs]
    labels = [text for _, ls in per_axis for text in ls]
    return owner.legend(handles, labels, **kwargs)


def _ax_wants_bright_highlight(ax, luminance_threshold: float = 0.5) -> bool:
    """True if the axes' dominant color is dark (→ use a bright stroke).

    Parity: display.py:4205 (__get_ax_bright_highlight) — median of the
    first mappable's data through its norm+cmap, else the axes (or figure)
    facecolor; luminance via RGB→YIQ.
    """
    import colorsys
    from matplotlib import cm

    mappable = None
    for child in ax.get_children():
        if isinstance(child, cm.ScalarMappable) and child.get_array() is not None:
            mappable = child
            break

    if mappable is not None:
        data = mappable.get_array()
        median_val = np.nanmedian(_host(data))
        rgba = mappable.get_cmap()(mappable.norm(median_val))
    else:
        rgba = ax.get_facecolor()
        if len(rgba) == 4 and rgba[3] == 0.0:
            rgba = ax.figure.get_facecolor()

    luminance = colorsys.rgb_to_yiq(*rgba[:3])[0]
    return luminance <= luminance_threshold


def highlight(
    *,
    artist: Optional[Any] = None,
    ax: Optional[Any] = None,
    color: Optional[Any] = None,
    bright_color: Any = "white",
    dark_color: Any = "black",
    luminance_threshold: float = 0.5,
    **kwargs: Any,
) -> List[Any]:
    """Add a contrast-stroke path effect so overlays stay visible.

    An f0 contour or beat-marker line drawn over a spectrogram can
    disappear into similarly-colored cells; this samples the luminance
    of the underlying axes images, picks ``bright_color`` on dark
    content or ``dark_color`` on bright content (threshold
    ``luminance_threshold``), and builds a
    :class:`matplotlib.patheffects.withStroke` outline in that color.

    Parameters
    ----------
    artist : matplotlib artist or None
        if given, the effect is applied to it in place
    ax : axes or None
        axes whose content decides the stroke color (defaults to the
        artist's axes, else the current axes)
    color : color or None
        explicit stroke color, bypassing the luminance decision
    bright_color, dark_color : color
        candidates chosen by background luminance
    luminance_threshold : float in [0, 1]
        background luminance above which ``dark_color`` is used
    **kwargs
        forwarded to ``withStroke`` (e.g. ``linewidth``)

    Returns
    -------
    effects : list of path effects, ready for ``set_path_effects``

    Parity: reference display.py:4251.
    """
    plt = _mpl()
    import matplotlib.patheffects as mpe

    target = ax
    if target is None:
        target = getattr(artist, "axes", None)
        if target is None:
            target = plt.gca()

    # stroke color: an explicit foreground/color wins; otherwise pick by
    # the axes' background luminance
    stroke = kwargs.pop("foreground", color)
    if stroke is None:
        bright = _ax_wants_bright_highlight(target, luminance_threshold)
        stroke = bright_color if bright else dark_color

    style = {"linewidth": 2, "alpha": 1.0, **kwargs}
    effects = [mpe.withStroke(foreground=stroke, **style)]
    if artist is not None:
        artist.set_path_effects(effects)
    return effects
