"""Sharded analysis: a signal split in time over the positions of a device mesh.

Each position owns a contiguous block of the signal and receives the halo
samples its frames need from its neighbours (overlap-save), so the sharded
spectrograms equal the unsharded ones. Global reductions (the dB clamp's
peak, PCEN's carried state) and the sequential decoders run as collectives
or on the joined result. A mesh may place several positions on one card or
on the CPU; across processes the halos and collectives go over
``torch.distributed`` (NCCL between cards, gloo between CPU processes).
"""

from .mesh import Mesh, init_distributed, make_mesh, pod_mesh, time_mesh  # noqa: F401
from .sharded import melspectrogram_sharded, stft_sharded  # noqa: F401
from .analysis import (  # noqa: F401
    beat_track_sharded,
    chroma_cqt_sharded,
    mfcc_sharded,
    onset_strength_sharded,
    pcen_sharded,
    pyin_sharded,
    tempo_sharded,
)
from .constantq import cqt_sharded  # noqa: F401
from .effects import hpss_sharded  # noqa: F401
