"""The benchmark of memo_tpu_torch on one NVIDIA H100: ``python3 portbench/run.py``."""
