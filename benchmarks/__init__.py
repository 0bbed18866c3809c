"""The benchmark of ``pyjac_tpu_torch`` on one CUDA card (``run.py``)."""
