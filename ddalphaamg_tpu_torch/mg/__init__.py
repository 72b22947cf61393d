"""Aggregation multigrid: interpolation, Galerkin operators, hierarchy."""
