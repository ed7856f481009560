"""Staged-copy diagnostics: how fast tiles of rows reach shared memory on the card.

``python -m librosa_tpu_torch.diagnostics.dma_bisect [variants]`` and
``python -m librosa_tpu_torch.diagnostics.dma_pipeline_micro [WRAP]`` run
the kernels of ``ops/staged_probe.py`` at the copy geometry of the
production mel kernel and print their times per tile.
"""
