"""Transformer layers of the code predictor (counterpart of
codeformer_tpu/nn/transformer.py), batch-major (B, S, E).

Plain matmuls with q k^T and the softmax in fp32, as in JAX; no fused
attention kernel. Parameter names and layouts are torch's
nn.MultiheadAttention ones (`in_proj_weight` (3E, E)), so reference
checkpoints load unchanged.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Linear):
    """nn.Linear computing in the input's dtype (fp32 parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with fp32 statistics, output in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class MultiheadSelfAttention(nn.Module):
    """torch.nn.MultiheadAttention's math with separate q/k and v inputs
    (the caller adds the position embedding to q and k only)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError('embed_dim must be divisible by num_heads')
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, qk_in: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
        e, h = self.embed_dim, self.num_heads
        d = e // h
        b, s, _ = qk_in.shape
        dt = qk_in.dtype
        w = self.in_proj_weight.to(dt)
        bias = self.in_proj_bias.to(dt)
        qk = F.linear(qk_in, w[:2 * e]) + bias[:2 * e]
        v = F.linear(v_in, w[2 * e:]) + bias[2 * e:]
        q = qk[..., :e].reshape(b, s, h, d).transpose(1, 2) * d ** -0.5
        k = qk[..., e:].reshape(b, s, h, d).transpose(1, 2)
        v = v.reshape(b, s, h, d).transpose(1, 2)
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
        attn = attn.softmax(-1).to(dt)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, s, e)
        return self.out_proj(out)


class TransformerSALayer(nn.Module):
    """Pre-LN block: LN -> MHA (q, k += pos) -> LN -> exact-GELU MLP
    (codeformer_arch.py:99-134; dropout is 0 in every shipped config)."""

    def __init__(self, embed_dim: int, nhead: int = 8, dim_mlp: int = 2048):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(embed_dim, nhead)
        self.linear1 = Linear(embed_dim, dim_mlp)
        self.linear2 = Linear(dim_mlp, embed_dim)
        self.norm1 = LayerNorm(embed_dim, eps=1e-5)
        self.norm2 = LayerNorm(embed_dim, eps=1e-5)

    def forward(self, tgt: torch.Tensor,
                query_pos: torch.Tensor | None = None) -> torch.Tensor:
        tgt2 = self.norm1(tgt)
        qk = tgt2 if query_pos is None else tgt2 + query_pos
        tgt = tgt + self.self_attn(qk, tgt2)
        tgt2 = self.linear2(F.gelu(self.linear1(self.norm2(tgt))))
        return tgt + tgt2
