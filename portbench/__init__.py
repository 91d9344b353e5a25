"""The benchmark of robosimgs_tpu_torch on one NVIDIA H100 (portbench/run.py)."""
