"""GNS, the graph network simulator baseline, with dense edges.

Port of ``cindm_tpu/baselines/gns.py``: an encoder-processor-decoder over
the n-body interaction graph, its edges a dense masked [n, n] adjacency
(edges where the distance is below the radius, plus self edges), message
passing as batched matmuls. Plain PyTorch: the JAX package runs it as XLA
matmuls, not as a kernel.

- node features: the (n_his - 1) velocity differences, the wall distances
  over the radius clipped to [-1, 1], a particle-type embedding;
- edge features: (delta pos / R, |delta pos| / R), the norm as
  sqrt(sum + 1e-12) so that self edges keep a finite gradient;
- ``gnn_layers`` rounds of an edge MLP on [receiver, sender, edge], a sum
  over senders, a node MLP on [node, effects]; residuals on the nodes that
  touch an edge (every node, with self edges) and on the edges;
- MLPs of two hidden ReLU layers and a LayerNorm (eps 1e-6, Flax's),
  the decoder without it.

``GNSNet(poss [B, n, n_his, 2], particle_type [B, n])`` gives accelerations
[B, n, out_size]; ``gns_rollout`` integrates one step at a time,
``gns_direct_rollout`` all steps of one call, and ``make_gns_loss`` is the
training loss of the three ``train_1d`` GNS method types.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.blocks import Dense
from ..models.unet1d import _dense


@dataclasses.dataclass(frozen=True)
class GNSConfig:
    n_his: int = 4
    hidden_size: int = 128
    gnn_layers: int = 5
    out_size: int = 2  # 2 = one acceleration step; 2k = k steps at once
    radius: float = 0.015
    particle_emb_size: int = 16
    num_particle_types: int = 1
    self_edge: bool = True
    bounds: tuple = ((0.0, 1.0), (0.0, 1.0))  # (lo, hi) per dimension, normalized box


class MLP(nn.Module):
    """Dense -> ReLU -> Dense -> ReLU -> Dense (-> LayerNorm, eps 1e-6)."""

    def __init__(self, d_in: int, hidden: int, out: int, layer_norm: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        self.dense = nn.ModuleList([Dense(d_in, hidden, generator=generator),
                                    Dense(hidden, hidden, generator=generator),
                                    Dense(hidden, out, generator=generator)])
        self.norm = nn.LayerNorm(out, eps=1e-6) if layer_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.dense[0](x))
        x = self.dense[2](F.relu(self.dense[1](x)))
        return x if self.norm is None else self.norm(x)


class GNSNet(nn.Module):
    """Acceleration predictor over position histories [B, n, n_his, 2]."""

    def __init__(self, cfg: GNSConfig = GNSConfig(), *, generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        h = cfg.hidden_size
        self.embed = nn.Parameter(
            torch.randn((cfg.num_particle_types, cfg.particle_emb_size), generator=g)
            / cfg.particle_emb_size ** 0.5)
        node_in = 2 * (cfg.n_his - 1) + 4 + cfg.particle_emb_size
        self.node_enc = MLP(node_in, h, h, generator=g)
        self.edge_enc = MLP(3, h, h, generator=g)
        self.edge_mlps = nn.ModuleList()
        self.node_mlps = nn.ModuleList()
        for _ in range(cfg.gnn_layers):
            self.edge_mlps.append(MLP(3 * h, h, h, generator=g))
            self.node_mlps.append(MLP(2 * h, h, h, generator=g))
        self.decoder = MLP(h, h, cfg.out_size, layer_norm=False, generator=g)
        bounds = torch.tensor(cfg.bounds, dtype=torch.float32)
        self.register_buffer("lo", bounds[:, 0], persistent=False)
        self.register_buffer("hi", bounds[:, 1], persistent=False)

    def forward(self, poss: torch.Tensor, particle_type: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, n, _, _ = poss.shape
        vels = (poss[:, :, 1:] - poss[:, :, :-1]).reshape(B, n, -1)
        pos_last = poss[:, :, -1]
        walls = torch.cat([pos_last - self.lo, self.hi - pos_last], dim=-1)
        walls = (walls / cfg.radius).clamp(-1.0, 1.0)
        nodes_in = torch.cat([vels, walls, self.embed[particle_type.long()]], dim=-1)

        # dense edges; row index = sender, column = receiver
        dvec = (pos_last[:, :, None, :] - pos_last[:, None, :, :]) / cfg.radius
        dist = torch.sqrt(dvec.square().sum(dim=-1, keepdim=True) + 1e-12)
        edges_in = torch.cat([dvec, dist], dim=-1)
        eye = torch.eye(n, dtype=torch.bool, device=poss.device)[None]
        adj = (dist[..., 0] < 1.0) & ~eye
        if cfg.self_edge:
            adj = adj | eye
        adj_f = adj.to(poss.dtype)[..., None]
        has_edge = adj.any(dim=2)[..., None].to(poss.dtype)

        h = cfg.hidden_size
        nodes = self.node_enc(nodes_in)
        edges = self.edge_enc(edges_in)
        for edge_mlp, node_mlp in zip(self.edge_mlps, self.node_mlps):
            src = nodes[:, :, None, :].expand(B, n, n, h)
            dst = nodes[:, None, :, :].expand(B, n, n, h)
            e_out = edge_mlp(torch.cat([dst, src, edges], dim=-1)) * adj_f
            effects = e_out.sum(dim=1)  # over senders: per receiver
            n_out = node_mlp(torch.cat([nodes, effects], dim=-1))
            nodes = nodes + n_out * has_edge
            edges = edges + e_out
        return self.decoder(nodes)

    def flax_mapping(self) -> Iterator[tuple[tuple[str, ...], str, Any]]:
        """(Flax key-path, state_dict key, transform) for every parameter:
        MLP_0 encodes nodes, MLP_1 edges, then an edge and a node MLP per
        layer, the decoder last."""
        yield ("Embed_0", "embedding"), "embed", None
        mlps = [("node_enc", True), ("edge_enc", True)]
        for i in range(self.cfg.gnn_layers):
            mlps += [(f"edge_mlps.{i}", True), (f"node_mlps.{i}", True)]
        mlps.append(("decoder", False))
        for k, (pk, ln) in enumerate(mlps):
            for j in range(3):
                yield from _dense((f"MLP_{k}", f"Dense_{j}"), f"{pk}.dense.{j}.")
            if ln:
                yield (f"MLP_{k}", "LayerNorm_0", "scale"), f"{pk}.norm.weight", None
                yield (f"MLP_{k}", "LayerNorm_0", "bias"), f"{pk}.norm.bias", None


def gns_rollout(model: Callable, poss0: torch.Tensor, particle_type: torch.Tensor,
                n_steps: int) -> torch.Tensor:
    """Autoregressive rollout x_{k+1} = x_k + (x_k - x_{k-1}) + a from
    histories [B, n, n_his, 2]. Returns positions [B, n, n_steps, 2]."""
    poss, out = poss0, []
    for _ in range(n_steps):
        acc = model(poss, particle_type)
        vel = poss[:, :, -1] - poss[:, :, -2]
        new_pos = poss[:, :, -1] + vel + acc
        poss = torch.cat([poss[:, :, 1:], new_pos[:, :, None]], dim=2)
        out.append(new_pos)
    return torch.stack(out, dim=2)


def gns_direct_rollout(model: Callable, poss0: torch.Tensor, particle_type: torch.Tensor,
                       n_steps: int) -> torch.Tensor:
    """One call predicts all n_steps accelerations (out_size = 2 n_steps),
    integrated twice. Returns positions [B, n, n_steps, 2]."""
    acc = model(poss0, particle_type)
    B, n, _ = acc.shape
    acc = acc.reshape(B, n, n_steps, 2)
    v_last = (poss0[:, :, -1] - poss0[:, :, -2])[:, :, None]
    vel = v_last + acc.cumsum(dim=2)
    return poss0[:, :, -1][:, :, None] + vel.cumsum(dim=2)


def make_gns_loss(cfg: GNSConfig, n_bodies: int, mode: str, time_interval: int = 4,
                  noise_std: float = 6.7e-7, generator: Optional[torch.Generator] = None):
    """``loss_fn(model, batch)`` of the GNS family over diffusion-layout
    batches {'x': [B, T, n*4] normalized}: L1 of the rolled-out positions
    plus L1 of their second differences, with random-walk noise on the
    input history. ``batch['noise']`` ([B*n, history, 2]) replaces the
    noise draw from ``generator``.

    Modes: "autoregress" (a real n_his-frame history, a 1-step model rolled
    out), "cond_one" (one (pos, vel) frame, its 2-frame history
    back-extrapolated at constant velocity), "direct" (as cond_one, every
    acceleration from one call)."""
    from ..utils.extras import random_walk_noise

    if mode not in ("autoregress", "cond_one", "direct"):
        raise ValueError(f"unknown GNS mode {mode!r}")

    def loss_fn(model: nn.Module, batch: dict) -> torch.Tensor:
        x = batch["x"]
        B, T, _ = x.shape
        xr = x.reshape(B, T, n_bodies, 4)
        pos = xr[..., :2].permute(0, 2, 1, 3)  # [B, n, T, 2]
        if mode == "autoregress":
            hist, tgt = pos[:, :, :cfg.n_his], pos[:, :, cfg.n_his:]
        else:
            # vel is stored in raw units / 200; a window frame spans time_interval steps
            vel0 = xr[:, 0, :, 2:] * (time_interval / 60.0)
            p0 = pos[:, :, 0]
            hist, tgt = torch.stack([p0 - vel0, p0], dim=2), pos[:, :, 1:]
        noise = batch.get("noise")
        if noise is None and noise_std > 0:
            noise = random_walk_noise(generator, (B * n_bodies, hist.shape[2], 2), noise_std,
                                      device=x.device)
        if noise is not None:
            hist = hist + noise.reshape(hist.shape)
        k = tgt.shape[2]
        ptype = torch.zeros((B, n_bodies), dtype=torch.long, device=x.device)
        rollout = gns_direct_rollout if mode == "direct" else gns_rollout
        pred = rollout(model, hist, ptype, k)
        pad = hist[:, :, -2:]

        def accs(seq):  # second differences a_j = p_{j+1} - 2 p_j + p_{j-1}
            return seq[:, :, 2:] - 2 * seq[:, :, 1:-1] + seq[:, :, :-2]

        pred_acc = accs(torch.cat([pad, pred], dim=2))
        tgt_acc = accs(torch.cat([pad, tgt], dim=2))
        return (pred - tgt).abs().mean() + (pred_acc - tgt_acc).abs().mean()

    return loss_fn
