"""The benchmark of pixo_tpu_torch: one command runs one cell once (``run.py``)."""
