"""Structure encoders: MultiGAT and MultiGCN over dense masked adjacency.

Counterpart of ``sgaligner_tpu/models/structure.py`` (``GATConvLayer``,
``MultiGAT``, ``GCNConvLayer``, ``MultiGCN``) with torch-geometric's
parameter names and shapes: GATConv ``lin_src.weight [H·out, in]``,
``att_src / att_dst [1, H, out]``, ``bias [H·out]``; GCNConv
``lin.weight [out, in]``, ``bias [out]``. MultiGAT: layer i > 0 takes
``n_units[i] · n_heads[i-1]`` inputs, ELU between layers, and in training
mode each layer's input goes through dropout. MultiGCN (EVA's): ReLU and
then dropout between layers. Dropout (p = ``dropout``) is drawn from the
generator the caller passes; at p = 0 and at inference it is the
identity, as flax's ``nn.Dropout`` is. Under data parallel (``mesh``) the
mask is drawn for the whole batch and each rank keeps its rows.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sgaligner_tpu_torch.ops.gat import gat_conv, gcn_conv
from sgaligner_tpu_torch.parallel.mesh import rand_rows


class LinearNoBias(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))


class GATConvLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, heads: int):
        super().__init__()
        self.heads, self.out_dim = heads, out_dim
        self.lin_src = LinearNoBias(in_dim, heads * out_dim)
        self.att_src = nn.Parameter(torch.empty(1, heads, out_dim))
        self.att_dst = nn.Parameter(torch.empty(1, heads, out_dim))
        self.bias = nn.Parameter(torch.zeros(heads * out_dim))

    def forward(self, x, adj, node_mask):
        dt = x.dtype
        w = self.lin_src.weight.to(dt)
        w = w.reshape(self.heads, self.out_dim, -1).permute(2, 0, 1)  # [in, H, out]
        return gat_conv(x, adj, node_mask, w, self.att_src[0].to(dt),
                        self.att_dst[0].to(dt), self.bias.to(dt))


class GCNConvLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.lin = LinearNoBias(in_dim, out_dim)
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x, adj, node_mask):
        dt = x.dtype
        return gcn_conv(x, adj, node_mask, self.lin.weight.t().to(dt),
                        self.bias.to(dt))


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None,
            mesh=None) -> torch.Tensor:
    """Inverted dropout: keep each value with probability 1 - p and scale
    the kept ones by 1 / (1 - p) (flax ``nn.Dropout``'s form). ``mesh``: x
    is this rank's block of the batch's rows (axis 0), and the mask is this
    block of the whole batch's."""
    if p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = rand_rows(mesh, x.shape, generator, x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class MultiGAT(nn.Module):
    def __init__(self, n_units: Sequence[int] = (3, 128, 128),
                 n_heads: Sequence[int] = (2, 2), dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        layers = []
        for i in range(len(n_units) - 1):
            in_dim = n_units[i] * n_heads[i - 1] if i else n_units[i]
            layers.append(GATConvLayer(in_dim, n_units[i + 1], n_heads[i]))
        self.layer_stack = nn.ModuleList(layers)

    def forward(self, x, adj, node_mask, generator=None, mesh=None):
        for i, layer in enumerate(self.layer_stack):
            if self.training:
                x = dropout(x, self.dropout, generator, mesh)
            x = layer(x, adj, node_mask)
            if i + 1 < len(self.layer_stack):
                x = F.elu(x)
        return x


class MultiGCN(nn.Module):
    def __init__(self, n_units: Sequence[int] = (3, 200, 400),
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.layer_stack = nn.ModuleList(
            GCNConvLayer(n_units[i], n_units[i + 1])
            for i in range(len(n_units) - 1))

    def forward(self, x, adj, node_mask, generator=None):
        for i, layer in enumerate(self.layer_stack):
            x = layer(x, adj, node_mask)
            if i + 1 < len(self.layer_stack):
                x = torch.relu(x)
                if self.training:
                    x = dropout(x, self.dropout, generator)
        return x
