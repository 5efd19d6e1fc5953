"""The benchmark of ``optimal_conv_tpu_torch`` on an NVIDIA H100 (see
``run.py``)."""
