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

The layers' parameters are stacked ``[L, ...]`` leaves, as the
reference scans them (``GNNLayers``); ``param_tree`` lists them in the
reference's tree, and the regimes and their losses (``full_graph_loss``,
``minibatch_loss``, ``molecule_loss``) are functions of that tree.
``gnn_partitioned`` (multi-device) waits for the multi-device paths.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig
from repro_torch.env import resolve_device
from .layers import (MLP, cross_entropy, dtype_of, init_dense, mlp_apply,
                     unstack)

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


def _layer_leaves(cfg: GNNConfig
                  ) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    """One layer's leaves as (path in the reference's per-layer dict,
    shape, init: ``dense``/``zeros``/``ones``), dense leaves in the order
    they are drawn."""
    h = cfg.d_hidden

    def mlp(name, dims):
        out = []
        for i in range(len(dims) - 1):
            out.append(((name, f"w{i}"), (dims[i], dims[i + 1]), "dense"))
            out.append(((name, f"bw{i}"), (dims[i + 1],), "zeros"))
        return out

    if cfg.name == "gatedgcn":
        return ([((k,), (h, h), "dense") for k in "ABCUV"]
                + [(("ln_n",), (h,), "ones"), (("ln_e",), (h,), "ones")])
    if cfg.name == "gin-tu":
        return mlp("mlp", (h, h, h)) + [(("eps",), (), "zeros"),
                                        (("ln",), (h,), "ones")]
    if cfg.name == "meshgraphnet":
        return (mlp("edge_mlp", (3 * h,) + (h,) * cfg.mlp_layers)
                + mlp("node_mlp", (2 * h,) + (h,) * cfg.mlp_layers)
                + [(("ln_n",), (h,), "ones"), (("ln_e",), (h,), "ones")])
    if cfg.name == "graphsage-reddit":
        return [(("w_self",), (h, h), "dense"), (("w_neigh",), (h, h), "dense"),
                (("ln",), (h,), "ones")]
    raise ValueError(cfg.name)


class GNNLayers(nn.Module):
    """The message-passing layers' parameters stacked as the reference
    scans them: one ``[L, ...]`` leaf per entry of its per-layer dict,
    an MLP's leaves in a dict of their own (``p`` and ``mlps``)."""

    def __init__(self, cfg: GNNConfig, dtype: torch.dtype,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = cfg.n_layers
        self.p = nn.ParameterDict()
        self.mlps = nn.ModuleDict()
        leaves = _layer_leaves(cfg)
        for path, shape, kind in leaves:
            w = torch.empty((n,) + shape, dtype=dtype, device=device)
            if kind == "ones":
                w.fill_(1.0)
            elif kind == "zeros" or generator is not None:
                w.zero_()
            self._holder(path)[path[-1]] = nn.Parameter(w)
        if generator is not None:
            with torch.no_grad():
                for i in range(n):      # layer by layer, as drawn before
                    for path, shape, kind in leaves:
                        if kind == "dense":
                            self._holder(path)[path[-1]][i].copy_(
                                init_dense(shape, dtype, generator, device))

    def _holder(self, path) -> nn.ParameterDict:
        if len(path) == 1:
            return self.p
        if path[0] not in self.mlps:
            self.mlps[path[0]] = nn.ParameterDict()
        return self.mlps[path[0]]

    def tree(self) -> Dict:
        out = dict(self.p)
        out.update({name: dict(pd) for name, pd in self.mlps.items()})
        return out


def _layer_edges(cfg: GNNConfig, p: Dict, hn: torch.Tensor,
                 he: Optional[torch.Tensor], src: torch.Tensor,
                 dst: torch.Tensor, n: int,
                 edge_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One message-passing layer with the layer's slice ``p`` of the
    stacked leaves.  hn: [N, H]; he: [E, H] or None; ``edge_mask`` [E]
    zeroes padded edges."""
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
        h_new = mlp_apply(p["mlp"], h_new, 2)
        out = torch.relu(_ln(h_new, p["ln"]))
        return (hn + out if cfg.residual else out), he

    if cfg.name == "meshgraphnet":
        e_in = torch.cat([he, h_src, h_dst], dim=-1)
        e_new = he + mlp_apply(p["edge_mlp"], e_in, cfg.mlp_layers)
        msg = e_new if em is None else e_new * em
        agg = segment_sum(msg, dst, n)
        n_in = torch.cat([hn, agg], dim=-1)
        hn = hn + mlp_apply(p["node_mlp"], n_in, cfg.mlp_layers)
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
        self.layers = GNNLayers(cfg, dt, dev, generator)

    def full_graph_logits(self, batch: Dict[str, torch.Tensor]
                          ) -> torch.Tensor:
        return full_graph_logits(param_tree(self), batch, self.cfg)

    def minibatch_logits(self, batch: Dict[str, torch.Tensor]
                         ) -> torch.Tensor:
        return minibatch_logits(param_tree(self), batch, self.cfg)

    def molecule_logits(self, batch: Dict[str, torch.Tensor]
                        ) -> torch.Tensor:
        return molecule_logits(param_tree(self), batch, self.cfg)


def param_tree(model: GNN) -> Dict:
    """The model's parameters in the reference's tree: ``{"encode",
    "decode", ["edge_encode",] "layers"}``, the layers' leaves stacked."""
    tree = {"encode": model.encode.tree(), "decode": model.decode.tree(),
            "layers": model.layers.tree()}
    if model.edge_encode is not None:
        tree["edge_encode"] = model.edge_encode.tree()
    return tree


# --------------------------------------------------------------- regime 1
def full_graph_logits(params: Dict, batch: Dict[str, torch.Tensor],
                      cfg: GNNConfig) -> torch.Tensor:
    """batch: node_feat [N, F], edge_index [2, E], edge_feat [E, Fe],
    optional edge_mask [E].  Returns [N, n_classes].  Under autograd each
    layer runs under ``torch.utils.checkpoint``, as the reference wraps
    it in ``jax.checkpoint``."""
    n = batch["node_feat"].shape[0]
    src = batch["edge_index"][0].long()
    dst = batch["edge_index"][1].long()
    em = batch.get("edge_mask")
    hn = mlp_apply(params["encode"], batch["node_feat"], 1, "enc", True)
    he = None
    if _needs_edge_feat(cfg):
        he = mlp_apply(params["edge_encode"], batch["edge_feat"], 1, "ee",
                       True)
        if em is not None:
            he = he * em[:, None]
    remat = torch.is_grad_enabled()
    for lp in unstack(params["layers"], cfg.n_layers):
        def layer(hn, he, lp=lp):
            return _layer_edges(cfg, lp, hn, he, src, dst, n, edge_mask=em)
        hn, he = (checkpoint(layer, hn, he, use_reentrant=False) if remat
                  else layer(hn, he))
    return mlp_apply(params["decode"], hn, 2, "dec")


def full_graph_loss(params: Dict, batch: Dict[str, torch.Tensor],
                    cfg: GNNConfig) -> torch.Tensor:
    return cross_entropy(full_graph_logits(params, batch, cfg),
                         batch["labels"], batch.get("label_mask"))


# --------------------------------------------------------------- regime 2
def minibatch_logits(params: Dict, batch: Dict[str, torch.Tensor],
                     cfg: GNNConfig) -> torch.Tensor:
    """batch: x0 [R, F] roots, x1 [R, f1, F], x2 [R, f1, f2, F]
    (+ masks).  Two-hop aggregation with the arch's own aggregator."""
    def enc(x):
        return mlp_apply(params["encode"], x, 1, "enc", True)

    h0, h1, h2 = enc(batch["x0"]), enc(batch["x1"]), enc(batch["x2"])
    m1 = batch["mask1"][..., None]
    m2 = batch["mask2"][..., None]

    def mean(h, m):
        return (h * m).sum(-2) / torch.clamp(m.sum(-2), min=1.0)

    if cfg.name == "graphsage-reddit":
        layers = params["layers"]
        lp0 = {k: w[0] for k, w in layers.items()}
        lp1 = {k: w[min(1, cfg.n_layers - 1)] for k, w in layers.items()}
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
    return mlp_apply(params["decode"], h0, 2, "dec")


def minibatch_loss(params: Dict, batch: Dict[str, torch.Tensor],
                   cfg: GNNConfig) -> torch.Tensor:
    return cross_entropy(minibatch_logits(params, batch, cfg),
                         batch["labels"])


# --------------------------------------------------------------- regime 3
def molecule_logits(params: Dict, batch: Dict[str, torch.Tensor],
                    cfg: GNNConfig) -> torch.Tensor:
    """batch: node_feat [B, N, F], edge_index [B, 2, E], edge_mask
    [B, E], node_mask [B, N], optional edge_feat [B, E, Fe].  Returns
    [B, n_classes]."""
    nf = batch["node_feat"]
    b, n = nf.shape[0], nf.shape[1]
    ei = batch["edge_index"].long()
    offs = (torch.arange(b, device=nf.device) * n)[:, None]
    src = (ei[:, 0] + offs).reshape(-1)
    dst = (ei[:, 1] + offs).reshape(-1)
    em = batch["edge_mask"].reshape(-1)[:, None]
    hn = mlp_apply(params["encode"], nf.reshape(b * n, -1), 1, "enc", True)
    he = None
    if _needs_edge_feat(cfg):
        ef = batch.get("edge_feat")
        if ef is None:
            ef = torch.zeros(tuple(batch["edge_mask"].shape)
                             + (_edge_feat_dim(cfg),),
                             dtype=nf.dtype, device=nf.device)
        he = mlp_apply(params["edge_encode"], ef.reshape(em.shape[0], -1),
                       1, "ee", True) * em
    for lp in unstack(params["layers"], cfg.n_layers):
        hn, he = _layer_edges(cfg, lp, hn, he, src, dst, b * n)
        if he is not None:
            he = he * em
    nm = batch["node_mask"]
    pooled = (hn.reshape(b, n, -1) * nm[..., None]).sum(1) / \
        torch.clamp(nm.sum(1), min=1.0)[:, None]            # mean readout
    return mlp_apply(params["decode"], pooled, 2, "dec")


def molecule_loss(params: Dict, batch: Dict[str, torch.Tensor],
                  cfg: GNNConfig) -> torch.Tensor:
    return cross_entropy(molecule_logits(params, batch, cfg),
                         batch["labels"])


def init_params(cfg: GNNConfig, generator: torch.Generator, d_feat: int,
                n_classes: Optional[int] = None,
                device: str | torch.device = "cuda") -> GNN:
    """Random parameters drawn from ``generator`` (which lives on
    ``device``) by the reference's scale rule: dense weights
    ``N(0, 1/fan_in)``, zero biases and eps, unit norm scales."""
    return GNN(cfg, d_feat, n_classes, device, generator=generator)


@torch.no_grad()
def from_reference_params(cfg: GNNConfig, params: Dict, d_feat: int,
                          n_classes: Optional[int] = None,
                          device: str | torch.device = "cuda") -> GNN:
    """The port's module holding the reference's parameters (a dict of
    numpy arrays); the stacked layer leaves copy over as they are."""
    model = GNN(cfg, d_feat, n_classes, device)
    model.encode.load_reference(params["encode"])
    model.decode.load_reference(params["decode"])
    if model.edge_encode is not None:
        model.edge_encode.load_reference(params["edge_encode"])

    def load(dst: Dict, src: Dict):
        for k, v in dst.items():
            if isinstance(v, dict):
                load(v, src[k])
            else:
                v.copy_(torch.from_numpy(np.array(src[k])))

    load(model.layers.tree(), params["layers"])
    return model
