"""Example recordings and audio files on disk, offline.

``example`` looks a recording up in a local directory (``LIBROSA_DATA_DIR``,
else ``~/librosa_tpu_data``) and downloads nothing; the registry of names is
kept here so that ``list_examples`` works without a network.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

from .exceptions import ParameterError

__all__ = ["example", "ex", "list_examples", "example_info", "find_files", "cite"]

# name -> description of the example recordings librosa knows
_EXAMPLES = {
    "brahms": "Brahms - Hungarian Dance #5",
    "choice": "Admiral Bob - Choice (drum+bass)",
    "fishin": "Karissa Hobbs - Let's Go Fishin'",
    "humpback": "Knuckles the humpback whale",
    "libri1": "LibriSpeech sample 1",
    "libri2": "LibriSpeech sample 2",
    "libri3": "LibriSpeech sample 3",
    "nutcracker": "Tchaikovsky - Dance of the Sugar Plum Fairy",
    "pibble": "Pibble the dog",
    "robin": "Robin bird song",
    "sweetwaltz": "Setuniman - Sweet Waltz",
    "trumpet": "Mihai Sorohan - Trumpet loop",
    "vibeace": "Kevin MacLeod - Vibe Ace",
    "pistachio": "The Piano Lady - Pistachio Ice Cream Ragtime",
}


def _data_dir() -> str:
    return os.environ.get(
        "LIBROSA_DATA_DIR", os.path.join(os.path.expanduser("~"), "librosa_tpu_data")
    )


def example(key: str, *, hq: bool = False) -> str:
    """The path of the local copy of example recording ``key``.

    The first file under the data directory whose name holds ``key`` and
    ends in ``.hq.ogg`` (``hq``), ``.ogg`` or ``.wav``. Raises
    ``ParameterError`` for an unknown key or a file that is not there.
    """
    if key not in _EXAMPLES:
        raise ParameterError(f"Unknown example key: {key}")
    ext = ".hq.ogg" if hq else ".ogg"
    for c in glob.glob(os.path.join(_data_dir(), f"*{key}*")):
        if c.endswith(ext) or c.endswith(".ogg") or c.endswith(".wav"):
            return c
    raise ParameterError(
        f"Example '{key}' not found locally. This build has no network access; "
        f"place the file under LIBROSA_DATA_DIR ({_data_dir()})."
    )


#: another name of :func:`example`
ex = example


def list_examples() -> None:
    """Print the example recordings' keys and descriptions."""
    print("AVAILABLE EXAMPLES")
    print("-" * 68)
    for key in sorted(_EXAMPLES):
        print(f"{key:10}\t{_EXAMPLES[key]}")


def example_info(key: str) -> None:
    """Print the description of example recording ``key``."""
    if key not in _EXAMPLES:
        raise ParameterError(f"Unknown example key: {key}")
    print(f"{key:10}\t{_EXAMPLES[key]}")


def find_files(
    directory: str,
    *,
    ext: Optional[List[str]] = None,
    recurse: bool = True,
    case_sensitive: bool = False,
    limit: Optional[int] = None,
    offset: int = 0,
) -> List[str]:
    """The sorted absolute paths of the audio files under ``directory``.

    ``ext`` lists the extensions to take (default aac, au, flac, m4a, mp3,
    ogg, wav); ``recurse`` descends into subdirectories; ``offset`` (negative:
    from the end) and ``limit`` cut the sorted list.
    """
    if ext is None:
        wanted = {"aac", "au", "flac", "m4a", "mp3", "ogg", "wav"}
    elif isinstance(ext, str):
        wanted = {ext}
    else:
        wanted = set(ext)
    if not case_sensitive:
        wanted = {e.lower() for e in wanted}

    def _accept(name: str) -> bool:
        _, dot, tail = name.rpartition(os.path.extsep)
        return bool(dot) and (tail if case_sensitive else tail.lower()) in wanted

    root = os.path.abspath(os.path.expanduser(directory))
    hits = []
    if recurse:
        for dirpath, _dirnames, filenames in os.walk(root):
            hits.extend(os.path.join(dirpath, f) for f in filenames if _accept(f))
    else:
        with os.scandir(root) as entries:
            hits.extend(e.path for e in entries if e.is_file() and _accept(e.name))
    hits.sort()
    window = hits[offset:]
    return window[:limit] if limit is not None else window


# the DOIs of the releases this build knows; the concept DOI covers all releases
_CITE_INDEX = {
    "0.10.0": "10.5281/zenodo.7746972",
    "0.10.1": "10.5281/zenodo.8252662",
    "0.10.2": "10.5281/zenodo.11192913",
}
_CONCEPT_DOI = "10.5281/zenodo.591533"


def cite(version: Optional[str] = None) -> str:
    """The ``https://doi.org/...`` citation of release ``version`` (None: of all releases).

    Raises ``ParameterError`` for a development version or one not in the index.
    """
    if version is None:
        doi = _CONCEPT_DOI
    else:
        doi = _CITE_INDEX.get(version)
        if doi is None:
            hint = ("development builds have no DOI until they are released" if "dev" in version
                    else "no release with that number is in the embedded index")
            raise ParameterError(f"No citation DOI for version {version!r}: {hint}")
    return f"https://doi.org/{doi}"
