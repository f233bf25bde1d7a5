"""CLI applications::

    python -m softx_2020_200_tpu_torch.apps.gls_navier_stokes_2d deck.prm --device cuda
    python -m softx_2020_200_tpu_torch.apps.gd_navier_stokes_2d deck.prm --device cuda
"""
