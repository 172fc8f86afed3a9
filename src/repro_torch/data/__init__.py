"""Synthetic circuit-hypergraph generators (numpy, shared seeds with
``repro.data``)."""
