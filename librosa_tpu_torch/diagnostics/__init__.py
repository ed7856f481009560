"""Diagnostics on the card: measurements that no path runs.

``python -m librosa_tpu_torch.diagnostics.dma_bisect [variants]`` and
``python -m librosa_tpu_torch.diagnostics.dma_pipeline_micro [WRAP]`` run
the kernels of ``ops/staged_probe.py`` at the copy geometry of the
production mel kernel and print their times per tile.
``python -m librosa_tpu_torch.diagnostics.viterbi_cluster`` times the
Viterbi kernel's cluster route at other cluster sizes and lanes a column
than the path's. ``python -m librosa_tpu_torch.diagnostics.path_enhance_routes``
times routes for ``segment.path_enhance``'s convolutions.
``python -m librosa_tpu_torch.diagnostics.rfft_batches`` shows whether
``torch.fft.rfft`` gives a frame the same bits in a smaller batch.
``python -m librosa_tpu_torch.diagnostics.peak_scan_parent --parent PATH``
times the ``peak_scan`` kernels beside an earlier build of their source on
the path's inputs.
"""
