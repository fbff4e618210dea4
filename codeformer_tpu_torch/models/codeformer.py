"""CodeFormer in PyTorch (counterpart of codeformer_tpu/models/codeformer.py):
VQGAN backbone + transformer code predictor + SFT fusion
(reference codeformer_arch.py:160-280).

Layouts: the image and feature maps are NCHW (channels_last memory), the
256-token path is batch-major (B, S, E). Code selection is the argmax of
the logits (the reference's softmax -> top-1 picks the same code).
Stage-II training runs `forward(..., code_only=True)`. The gradient cuts
are JAX's: `detach_16` stops the gradient at the looked-up codebook
features, and the encoder features handed to the fuse blocks never pass
a gradient back. The staged-split methods of the JAX model wait for
stage III.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from codeformer_tpu_torch.nn.blocks import (FuseSftBlock,
                                            adaptive_instance_normalization)
from codeformer_tpu_torch.nn.transformer import (LayerNorm, Linear,
                                                 TransformerSALayer)
from codeformer_tpu_torch.utils.profiler import span
from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY
from .vqgan import VQAutoEncoder


@ARCH_REGISTRY.register()
class CodeFormer(VQAutoEncoder):
    """Backbone defaults are the reference's fixed super() call
    (codeformer_arch.py:166): img_size 512, nf 64, ch_mult
    (1, 2, 2, 4, 4, 8), 2 res blocks, attention at 16. `remat`: every
    ResBlock, the fuse blocks' too, recomputes its interior in the
    backward (VQAutoEncoder)."""

    def __init__(self, dim_embd: int = 512, n_head: int = 8,
                 n_layers: int = 9, codebook_size: int = 1024,
                 latent_size: int = 256,
                 connect_list: Sequence[str] = ('32', '64', '128', '256'),
                 img_size: int = 512, nf: int = 64,
                 ch_mult: Sequence[int] = (1, 2, 2, 4, 4, 8),
                 res_blocks: int = 2, attn_resolutions=(16,),
                 emb_dim: int = 256, remat: bool = False):
        super().__init__(img_size=img_size, nf=nf, ch_mult=ch_mult,
                         res_blocks=res_blocks,
                         attn_resolutions=attn_resolutions,
                         codebook_size=codebook_size, emb_dim=emb_dim,
                         remat=remat)
        self.connect_list = tuple(connect_list)
        self.position_emb = nn.Parameter(torch.zeros(latent_size, dim_embd))
        self.feat_emb = Linear(emb_dim, dim_embd)
        self.ft_layers = nn.ModuleList(
            TransformerSALayer(dim_embd, n_head, dim_embd * 2)
            for _ in range(n_layers))
        # logits head: LayerNorm + biasless Linear (codeformer_arch.py:191)
        self.idx_pred_layer = nn.Sequential(
            LayerNorm(dim_embd, eps=1e-5),
            Linear(dim_embd, codebook_size, bias=False))
        n_stage = len(self.ch_mult)
        channels = {str(img_size // 2 ** s): nf * self.ch_mult[min(s, n_stage - 1)]
                    for s in range(n_stage)}
        self.fuse_convs_dict = nn.ModuleDict(
            {f: FuseSftBlock(channels[f], channels[f], remat)
             for f in self.connect_list})

    def predict_codes(self, x: torch.Tensor, code_only: bool = False):
        """The forward's first half: the encoder, the transformer and
        the argmax. x: (B, 3, H, W) in [-1, 1]. Returns (logits, top_idx,
        lq_feat, enc_feats); top_idx is None with `code_only`. The
        codebook lookup between the halves is `quantize.get_codebook_feat`
        (the restorer calls it eagerly between its two CUDA graphs)."""
        taps = [self.encoder.tap_by_size[s] for s in self.connect_list]
        with span('model.encode'):
            lq_feat, enc_feats = self.encoder(x, taps)
        with span('model.transformer'):
            query = self.feat_emb(lq_feat.flatten(2).transpose(1, 2))
            pos = self.position_emb[None].to(query.dtype)
            for layer in self.ft_layers:
                query = layer(query, query_pos=pos)
            logits = self.idx_pred_layer(query)             # (B, S, K)
            top_idx = None if code_only else logits.argmax(-1)
        return logits, top_idx, lq_feat, enc_feats

    def lookup_codes(self, top_idx: torch.Tensor,
                     lq_feat: torch.Tensor) -> torch.Tensor:
        """The codebook features of top_idx (B, S), an NCHW map shaped
        as lq_feat, in its dtype."""
        b, _, h, wd = lq_feat.shape
        return self.quantize.get_codebook_feat(
            top_idx, shape=(b, h, wd, self.emb_dim), dtype=lq_feat.dtype)

    def decode_codes(self, quant_feat: torch.Tensor, lq_feat: torch.Tensor,
                     enc_feats, w=0.0, detach_16: bool = True,
                     adain: bool = False,
                     enable_fuse: bool = True) -> torch.Tensor:
        """The forward's second half: AdaIN of the looked-up features to
        lq_feat's statistics, then the generator with SFT fusion of the
        encoder taps. Returns the image (B, 3, H, W)."""
        if detach_16:
            quant_feat = quant_feat.detach()
        with span('model.generate'):
            if adain:
                quant_feat = adaptive_instance_normalization(quant_feat,
                                                             lq_feat)
            fuse_fns = {}
            if enable_fuse:
                gen_taps = self.generator.tap_by_size
                for f_size in self.connect_list:
                    fuse = self.fuse_convs_dict[f_size]
                    enc = enc_feats[f_size].detach()
                    fuse_fns[gen_taps[f_size]] = (
                        lambda dec, fuse=fuse, enc=enc: fuse(enc, dec, w))
            return self.generator(quant_feat, fuse_fns=fuse_fns)

    def forward(self, x: torch.Tensor, w=0.0, detach_16: bool = True,
                code_only: bool = False, adain: bool = False,
                enable_fuse: bool = True):
        """x: (B, 3, H, W) in [-1, 1]. Returns (out, logits, lq_feat), or
        (logits, lq_feat) with code_only: `predict_codes`, `lookup_codes`,
        `decode_codes`. `detach_16` stops the gradient at the codebook
        features before AdaIN (JAX models/codeformer.py:124-125); the
        encoder taps reach the fuse blocks detached, always (:139).
        `enable_fuse` is the reference's `w > 0` gate (False skips the
        SFT fusion)."""
        logits, top_idx, lq_feat, enc_feats = self.predict_codes(x,
                                                                 code_only)
        if code_only:
            return logits, lq_feat
        quant_feat = self.lookup_codes(top_idx, lq_feat)
        out = self.decode_codes(quant_feat, lq_feat, enc_feats, w,
                                detach_16, adain, enable_fuse)
        return out, logits, lq_feat
