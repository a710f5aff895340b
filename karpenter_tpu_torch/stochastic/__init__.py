"""Chance-constrained packing: the encode-time half (``usage_rows``).

Windows whose pool overcommits take the reference's stochastic route,
which this package does not serve yet.
"""
