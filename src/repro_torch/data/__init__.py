"""Synthetic data of the port (counterpart of ``repro.data``): the
circuit-hypergraph generators, graphs, click logs, the neighbour
sampler and the LM token stream (numpy, shared seeds with
``repro.data``)."""
