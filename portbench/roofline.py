"""The yardstick of the kernel rooflines: published peaks and the work of each kernel's call.

The work is counted from the cell's shapes and is the same whatever
implements it. The peaks are NVIDIA's data sheet for one H100 SXM at its
full 700 W power limit; the power limit of the card that ran is printed
beside every run (``run.py``), since a card set lower reaches less.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12     # float32 outside the tensor cores, per second
PEAK_HBM_BYTES = 3.35e12    # HBM3, bytes per second


def stft_flops_per_frame(n_fft: int, basis_nnz: int) -> int:
    """Operations of one frame of a power spectrum projected onto a basis.

    The window (``n_fft`` multiplies), a real FFT (``2.5 n_fft log2 n_fft``,
    half the ``5 N log2 N`` of a complex one), ``|X|**2`` (3 per bin) and
    the projection through the basis's ``basis_nnz`` nonzeros (a multiply
    and an add each).
    """
    log2_n = n_fft.bit_length() - 1
    return n_fft + (5 * n_fft * log2_n) // 2 + 3 * (n_fft // 2 + 1) + 2 * basis_nnz


def stft_work(rows: int, samples: int, *, n_fft: int, hop: int, n_out: int,
              basis_nnz: int) -> dict:
    """Operations and bytes of one call of the fused STFT and projection on ``(rows, samples)``
    float32 (centred frames): the input read once, the ``(rows, n_out, T)`` output written once."""
    T = 1 + samples // hop
    return {"flops": rows * T * stft_flops_per_frame(n_fft, basis_nnz),
            "bytes": 4 * rows * samples + 4 * rows * n_out * T}


def viterbi_work(rows: int, frames: int, n_states: int, finite_pairs: int) -> dict:
    """Operations and bytes of one max-plus Viterbi decode: 2 operations (an add and a max) per
    finite transition pair per step, and the ``(rows, frames, n_states)`` float32 observation
    read once."""
    return {"flops": 2 * rows * (frames - 1) * finite_pairs,
            "bytes": 4 * rows * frames * n_states}


def least_seconds(work: dict) -> float:
    """The least time the peaks allow for ``work``: the larger of its two bounds."""
    return max(work["flops"] / PEAK_FP32_FLOPS, work["bytes"] / PEAK_HBM_BYTES)
