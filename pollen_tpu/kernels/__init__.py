"""Masked-depth index builders and their query reductions."""
