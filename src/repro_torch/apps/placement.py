"""The paper's technique as a first-class framework feature (DESIGN.md §4;
port of ``repro.apps.placement``): IMPart drives *placement* decisions
for the distributed substrates.

1. ``partition_graph_for_mesh`` — GNN full-batch sharding: nodes ->
   devices minimising cross-device edges (halo volume).  A graph is a
   2-uniform hypergraph; cut == #edges crossing devices == bytes on the
   wire per layer.
2. ``partition_embedding_rows`` — DLRM: queries are hyperedges over the
   rows they touch; row placement minimising multi-shard queries.
3. ``place_experts`` — MoE: expert co-activation hypergraph; placement
   minimising cross-pod token routing.

Each returns the assignment plus before/after communication-volume
estimates, and runs the partitioner on ``device`` (the card by
default).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import (Hypergraph, ImpartConfig, impart_partition,
                              metrics, multilevel_partition, refine)
from repro_torch.env import resolve_device


@dataclasses.dataclass
class PlacementResult:
    assignment: np.ndarray          # object -> device/block
    cut: float                      # optimised objective
    random_cut: float               # hash-placement baseline
    reduction: float                # 1 - cut/random_cut
    wall_s: float


def _solve(hg: Hypergraph, k: int, eps: float, seed: int, quality: str,
           dev: torch.device) -> Tuple[np.ndarray, float, float]:
    t0 = time.perf_counter()
    if quality == "fast":
        res = multilevel_partition(hg, k, eps, seed=seed, device=dev)
    else:
        res = impart_partition(hg, ImpartConfig(
            k=k, eps=eps, alpha=3 if quality == "balanced" else 5,
            beta=3 if quality == "balanced" else 5, seed=seed,
            final_vcycles=0), device=dev)
    return res.part, res.cut, time.perf_counter() - t0


def _random_cut(hg: Hypergraph, k: int, seed: int, dev: torch.device
                ) -> float:
    rng = np.random.default_rng(seed)
    part = rng.integers(0, k, hg.n).astype(np.int32)
    hga = hg.arrays(device=dev)
    return float(metrics.cutsize(hga, refine.pad_part(part, hga.n_pad, dev),
                                 k))


def _result(hg: Hypergraph, k: int, eps: float, seed: int, quality: str,
            device) -> PlacementResult:
    dev = resolve_device(device)
    part, cut, wall = _solve(hg, k, eps, seed, quality, dev)
    rcut = _random_cut(hg, k, seed + 1, dev)
    return PlacementResult(part, cut, rcut, 1.0 - cut / max(rcut, 1e-9),
                           wall)


def graph_hypergraph(edge_index: np.ndarray, n_nodes: int) -> Hypergraph:
    """The 2-uniform hypergraph of a graph: one edge per distinct
    undirected node pair, self-loops dropped."""
    src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    keep = src != dst
    edges = np.stack([src[keep], dst[keep]], axis=1)
    # dedupe undirected pairs (cut counts a pair once)
    lo = edges.min(1)
    hi = edges.max(1)
    key = lo.astype(np.int64) * n_nodes + hi
    _, first = np.unique(key, return_index=True)
    return Hypergraph.from_edge_lists(list(edges[first]), n=n_nodes)


def partition_graph_for_mesh(edge_index: np.ndarray, n_nodes: int,
                             n_devices: int, eps: float = 0.06,
                             seed: int = 0, quality: str = "balanced",
                             device: str | torch.device = "cuda"
                             ) -> PlacementResult:
    """Nodes -> devices for owner-compute GNN sharding.  Cut edges =
    halo-exchange entries per layer."""
    return _result(graph_hypergraph(edge_index, n_nodes), n_devices, eps,
                   seed, quality, device)


def set_hypergraph(rows: np.ndarray, n: int) -> Hypergraph:
    """One edge per row of ``rows`` that names at least two distinct
    ids: a query's rows, or a token's experts."""
    edges = []
    for q in np.asarray(rows):
        u = np.unique(q)
        if len(u) >= 2:
            edges.append(u)
    return Hypergraph.from_edge_lists(edges, n=n)


def partition_embedding_rows(query_rows: np.ndarray, n_rows: int,
                             n_shards: int, eps: float = 0.10,
                             seed: int = 0, quality: str = "balanced",
                             device: str | torch.device = "cuda"
                             ) -> PlacementResult:
    """query_rows [Q, S]: the rows each query touches (one per sparse
    feature).  Hyperedge per query; cut = queries spanning >1 shard."""
    return _result(set_hypergraph(query_rows, n_rows), n_shards, eps, seed,
                   quality, device)


def place_experts(coactivation: np.ndarray, n_pods: int,
                  eps: float = 0.25, seed: int = 0,
                  device: str | torch.device = "cuda") -> PlacementResult:
    """coactivation [T, k']: experts activated together per token (top-k
    routing trace).  Hyperedge per token; cut = tokens whose experts span
    pods (cross-pod all-to-all)."""
    n_experts = int(np.asarray(coactivation).max()) + 1
    return _result(set_hypergraph(coactivation, n_experts), n_pods, eps,
                   seed, "fast", device)


def halo_volume(edge_index: np.ndarray, assignment: np.ndarray,
                feat_bytes: int) -> int:
    """Bytes/layer of halo exchange under an assignment."""
    src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    cross = assignment[src] != assignment[dst]
    # each cross edge ships one feature row (dedup by (node, peer) pairs)
    key = (np.asarray(src, np.int64) * (assignment.max() + 1)
           + assignment[dst])
    remote = np.unique(key[cross])
    return int(len(remote)) * feat_bytes
