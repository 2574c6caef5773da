"""The benchmark of manuscript_tpu_torch: ``python3 perfbench/run.py``."""
