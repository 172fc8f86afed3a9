"""GNN zoo: GatedGCN, GIN, MeshGraphNet, GraphSAGE (port of
``repro.models.gnn``'s forward regimes).

Message passing is a gather (``hn[src]``) plus a segment sum over the
destination ids, here ``index_add_`` into zeros: plain torch ops, as the
reference computes them with ``jnp.take`` and ``jax.ops.segment_sum``
outside any kernel.  Three input regimes, as in the reference:

* ``full_graph_logits``: one graph as edge lists [2, E].
* ``minibatch_logits``: GraphSAGE-style sampled fanout tensors
  [R, f1], [R, f1, f2] from ``data.sampler.NeighborSampler``.
* ``molecule_logits``: batches of small padded graphs [B, N, ...] with
  per-graph edge lists and a graph-level readout.  The reference maps one
  graph at a time (``vmap``); here the B graphs are one graph of B * N
  nodes with each graph's ids offset, which gives every graph the same
  segment sums.

The reference's ``lax.scan`` over stacked layer parameters is a
``ModuleList``; ``from_reference_params`` unstacks the scanned leaves.
The losses come with training; ``gnn_partitioned`` (multi-device) waits
for the multi-device paths.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.env import resolve_device
from .layers import MLP, dtype_of, init_dense

def segment_sum(x: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    return x.new_zeros((num,) + tuple(x.shape[1:])).index_add_(0, seg, x)


def segment_mean(x: torch.Tensor, seg: torch.Tensor, num: int
                 ) -> torch.Tensor:
    s = segment_sum(x, seg, num)
    c = segment_sum(torch.ones(seg.shape, dtype=x.dtype, device=x.device),
                    seg, num)
    return s / torch.clamp(c, min=1.0)[..., None]


def _ln(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
        ) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale


def _needs_edge_feat(cfg: GNNConfig) -> bool:
    return cfg.name in ("gatedgcn", "meshgraphnet")


def _edge_feat_dim(cfg: GNNConfig) -> int:
    return {"gatedgcn": 1, "meshgraphnet": 4}.get(cfg.name, 0)


class GNNLayer(nn.Module):
    """One message-passing layer's parameters, named as the reference's
    per-layer dict: dense leaves in ``p``, MLPs as submodules."""

    def __init__(self, cfg: GNNConfig, dtype: torch.dtype,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h = cfg.d_hidden

        def dense(shape):
            if generator is None:
                return nn.Parameter(torch.empty(shape, dtype=dtype,
                                                device=device))
            return nn.Parameter(init_dense(shape, dtype, generator, device))

        def ones():
            return nn.Parameter(torch.ones(h, dtype=dtype, device=device))

        if cfg.name == "gatedgcn":
            self.p = nn.ParameterDict(
                {k: dense((h, h)) for k in "ABCUV"})
            self.p.update({"ln_n": ones(), "ln_e": ones()})
        elif cfg.name == "gin-tu":
            self.mlp = MLP((h, h, h), dtype, device, generator=generator)
            self.p = nn.ParameterDict({
                "eps": nn.Parameter(torch.zeros((), dtype=dtype,
                                                device=device)),
                "ln": ones()})
        elif cfg.name == "meshgraphnet":
            self.edge_mlp = MLP((3 * h,) + (h,) * cfg.mlp_layers, dtype,
                                device, generator=generator)
            self.node_mlp = MLP((2 * h,) + (h,) * cfg.mlp_layers, dtype,
                                device, generator=generator)
            self.p = nn.ParameterDict({"ln_n": ones(), "ln_e": ones()})
        elif cfg.name == "graphsage-reddit":
            self.p = nn.ParameterDict({"w_self": dense((h, h)),
                                       "w_neigh": dense((h, h)),
                                       "ln": ones()})
        else:
            raise ValueError(cfg.name)

    @torch.no_grad()
    def load_reference(self, lp: Dict) -> None:
        """Copy one layer's slice of the reference's stacked leaves."""
        for name, leaf in lp.items():
            if isinstance(leaf, dict):
                getattr(self, name).load_reference(leaf)
            else:
                self.p[name].copy_(torch.from_numpy(np.array(leaf)))


def _layer_edges(cfg: GNNConfig, lp: GNNLayer, hn: torch.Tensor,
                 he: Optional[torch.Tensor], src: torch.Tensor,
                 dst: torch.Tensor, n: int,
                 edge_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One message-passing layer.  hn: [N, H]; he: [E, H] or None;
    ``edge_mask`` [E] zeroes padded edges."""
    p = lp.p
    h_src = hn[src]
    h_dst = hn[dst]
    em = None if edge_mask is None else edge_mask[:, None]

    if cfg.name == "gatedgcn":
        e_new = h_dst @ p["A"] + h_src @ p["B"] + he @ p["C"]
        gate = torch.sigmoid(e_new)
        if em is not None:
            gate = gate * em
        msg = gate * (h_src @ p["V"])
        agg = segment_sum(msg, dst, n)
        den = segment_sum(gate, dst, n)
        h_new = hn @ p["U"] + agg / (torch.abs(den) + 1e-6)
        hn = hn + torch.relu(_ln(h_new, p["ln_n"]))
        he = he + torch.relu(_ln(e_new, p["ln_e"]))
        return hn, he

    if cfg.name == "gin-tu":
        msg = h_src if em is None else h_src * em
        agg = segment_sum(msg, dst, n)
        h_new = (1.0 + p["eps"]) * hn + agg
        h_new = lp.mlp(h_new)
        out = torch.relu(_ln(h_new, p["ln"]))
        return (hn + out if cfg.residual else out), he

    if cfg.name == "meshgraphnet":
        e_in = torch.cat([he, h_src, h_dst], dim=-1)
        e_new = he + lp.edge_mlp(e_in)
        msg = e_new if em is None else e_new * em
        agg = segment_sum(msg, dst, n)
        n_in = torch.cat([hn, agg], dim=-1)
        hn = hn + lp.node_mlp(n_in)
        return _ln(hn, p["ln_n"]), _ln(e_new, p["ln_e"])

    if cfg.name == "graphsage-reddit":
        msg = h_src if em is None else h_src * em
        if em is None:
            agg = segment_mean(msg, dst, n)
        else:  # masked mean: padded edges do not count
            ssum = segment_sum(msg, dst, n)
            cnt = segment_sum(edge_mask, dst, n)
            agg = ssum / torch.clamp(cnt, min=1.0)[..., None]
        h_new = hn @ p["w_self"] + agg @ p["w_neigh"]
        return torch.relu(_ln(h_new, p["ln"])), he

    raise ValueError(cfg.name)


class GNN(nn.Module):
    """One arch of the zoo on one device.  The constructor leaves the
    dense weights uninitialised unless given a ``generator``: build one
    with ``init_params`` or ``from_reference_params``."""

    def __init__(self, cfg: GNNConfig, d_feat: int,
                 n_classes: Optional[int] = None,
                 device: str | torch.device = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dt = dtype_of(cfg.dtype)
        h = cfg.d_hidden
        self.cfg = cfg
        self.encode = MLP((d_feat, h), dt, dev, prefix="enc",
                          final_act=True, generator=generator)
        self.decode = MLP((h, h, n_classes or cfg.n_classes), dt, dev,
                          prefix="dec", generator=generator)
        self.edge_encode = (MLP((_edge_feat_dim(cfg), h), dt, dev,
                                prefix="ee", final_act=True,
                                generator=generator)
                            if _needs_edge_feat(cfg) else None)
        self.layers = nn.ModuleList(
            GNNLayer(cfg, dt, dev, generator) for _ in range(cfg.n_layers))

    # ---------------------------------------------------------- regime 1
    def full_graph_logits(self, batch: Dict[str, torch.Tensor]
                          ) -> torch.Tensor:
        """batch: node_feat [N, F], edge_index [2, E], edge_feat [E, Fe],
        optional edge_mask [E].  Returns [N, n_classes]."""
        cfg = self.cfg
        n = batch["node_feat"].shape[0]
        src = batch["edge_index"][0].long()
        dst = batch["edge_index"][1].long()
        em = batch.get("edge_mask")
        hn = self.encode(batch["node_feat"])
        he = None
        if _needs_edge_feat(cfg):
            he = self.edge_encode(batch["edge_feat"])
            if em is not None:
                he = he * em[:, None]
        for lp in self.layers:
            hn, he = _layer_edges(cfg, lp, hn, he, src, dst, n,
                                  edge_mask=em)
        return self.decode(hn)

    # ---------------------------------------------------------- regime 2
    def minibatch_logits(self, batch: Dict[str, torch.Tensor]
                         ) -> torch.Tensor:
        """batch: x0 [R, F] roots, x1 [R, f1, F], x2 [R, f1, f2, F]
        (+ masks).  Two-hop aggregation with the arch's own aggregator."""
        cfg = self.cfg
        h0, h1, h2 = (self.encode(batch["x0"]), self.encode(batch["x1"]),
                      self.encode(batch["x2"]))
        m1 = batch["mask1"][..., None]
        m2 = batch["mask2"][..., None]

        def mean(h, m):
            return (h * m).sum(-2) / torch.clamp(m.sum(-2), min=1.0)

        if cfg.name == "graphsage-reddit":
            lp0 = self.layers[0].p
            lp1 = self.layers[min(1, cfg.n_layers - 1)].p
            p1 = mean(h2, m2)
            h1 = torch.relu(_ln(h1 @ lp0["w_self"] + p1 @ lp0["w_neigh"],
                                lp0["ln"]))
            p0 = mean(h1, m1)
            h0 = torch.relu(_ln(h0 @ lp1["w_self"] + p0 @ lp1["w_neigh"],
                                lp1["ln"]))
        else:  # sum / gated reduce to a sum in the sampled regime
            pool = mean if cfg.aggregator == "mean" else \
                (lambda h, m: (h * m).sum(-2))
            h1 = h1 + pool(h2, m2)
            h0 = h0 + pool(h1, m1)
        return self.decode(h0)

    # ---------------------------------------------------------- regime 3
    def molecule_logits(self, batch: Dict[str, torch.Tensor]
                        ) -> torch.Tensor:
        """batch: node_feat [B, N, F], edge_index [B, 2, E], edge_mask
        [B, E], node_mask [B, N], optional edge_feat [B, E, Fe].  Returns
        [B, n_classes]."""
        cfg = self.cfg
        nf = batch["node_feat"]
        b, n = nf.shape[0], nf.shape[1]
        ei = batch["edge_index"].long()
        offs = (torch.arange(b, device=nf.device) * n)[:, None]
        src = (ei[:, 0] + offs).reshape(-1)
        dst = (ei[:, 1] + offs).reshape(-1)
        em = batch["edge_mask"].reshape(-1)[:, None]
        hn = self.encode(nf.reshape(b * n, -1))
        he = None
        if _needs_edge_feat(cfg):
            ef = batch.get("edge_feat")
            if ef is None:
                ef = torch.zeros(tuple(batch["edge_mask"].shape)
                                 + (_edge_feat_dim(cfg),),
                                 dtype=nf.dtype, device=nf.device)
            he = self.edge_encode(ef.reshape(em.shape[0], -1)) * em
        for lp in self.layers:
            hn, he = _layer_edges(cfg, lp, hn, he, src, dst, b * n)
            if he is not None:
                he = he * em
        nm = batch["node_mask"]
        pooled = (hn.reshape(b, n, -1) * nm[..., None]).sum(1) / \
            torch.clamp(nm.sum(1), min=1.0)[:, None]        # mean readout
        return self.decode(pooled)


def init_params(cfg: GNNConfig, generator: torch.Generator, d_feat: int,
                n_classes: Optional[int] = None,
                device: str | torch.device = "cuda") -> GNN:
    """Random parameters drawn from ``generator`` (which lives on
    ``device``) by the reference's scale rule: dense weights
    ``N(0, 1/fan_in)``, zero biases and eps, unit norm scales."""
    return GNN(cfg, d_feat, n_classes, device, generator=generator)


def from_reference_params(cfg: GNNConfig, params: Dict, d_feat: int,
                          n_classes: Optional[int] = None,
                          device: str | torch.device = "cuda") -> GNN:
    """The port's module holding the reference's parameters (a dict of
    numpy arrays); layer ``i`` takes index ``i`` of every scanned leaf."""
    model = GNN(cfg, d_feat, n_classes, device)
    model.encode.load_reference(params["encode"])
    model.decode.load_reference(params["decode"])
    if model.edge_encode is not None:
        model.edge_encode.load_reference(params["edge_encode"])

    def layer_slice(tree, i):
        return {k: (layer_slice(v, i) if isinstance(v, dict)
                    else np.asarray(v)[i]) for k, v in tree.items()}

    for i, lp in enumerate(model.layers):
        lp.load_reference(layer_slice(params["layers"], i))
    return model
