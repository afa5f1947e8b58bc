"""Structure encoder: MultiGAT over dense masked adjacency.

Counterpart of ``sgaligner_tpu/models/structure.py`` (``GATConvLayer``,
``MultiGAT``) with torch-geometric GATConv's parameter names and shapes
(``lin_src.weight [H·out, in]``, ``att_src / att_dst [1, H, out]``,
``bias [H·out]``). Layer i > 0 takes ``n_units[i] · n_heads[i-1]`` inputs;
ELU between layers; dropout is the identity at inference.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sgaligner_tpu_torch.ops.gat import gat_conv


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


class MultiGAT(nn.Module):
    def __init__(self, n_units: Sequence[int] = (3, 128, 128),
                 n_heads: Sequence[int] = (2, 2)):
        super().__init__()
        layers = []
        for i in range(len(n_units) - 1):
            in_dim = n_units[i] * n_heads[i - 1] if i else n_units[i]
            layers.append(GATConvLayer(in_dim, n_units[i + 1], n_heads[i]))
        self.layer_stack = nn.ModuleList(layers)

    def forward(self, x, adj, node_mask):
        for i, layer in enumerate(self.layer_stack):
            x = layer(x, adj, node_mask)
            if i + 1 < len(self.layer_stack):
                x = F.elu(x)
        return x
