"""Version of the PyTorch port."""

from __future__ import annotations

version = "0.1.0"
short_version = "0.1"


def show_versions() -> None:
    """Print the port's version and those of its dependencies."""
    import sys

    print(f"librosa_tpu_torch: {version}")
    print(f"python: {sys.version}")
    for mod in ("torch", "numpy", "scipy"):
        try:
            m = __import__(mod)
        except ImportError:
            print(f"{mod}: not installed")
            continue
        print(f"{mod}: {getattr(m, '__version__', 'unknown')}")
