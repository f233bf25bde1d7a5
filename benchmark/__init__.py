"""The benchmark of softx_2020_200_tpu_torch: ``run.py`` is its entry."""
