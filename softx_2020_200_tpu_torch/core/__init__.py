"""Core runtime: .prm decks, expressions, typed parameters, BDF/SDIRK
coefficients and simulation control (counterpart of
``softx_2020_200_tpu.core``)."""
