"""The benchmark of tpu_unet_torch on the H100: `python3 benchmarks/run.py`."""
