"""The benchmark of librosa_tpu_torch on an NVIDIA card: ``python3 portbench/run.py --help``."""
