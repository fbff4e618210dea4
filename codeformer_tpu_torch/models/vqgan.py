"""VQGAN backbone in PyTorch (counterpart of codeformer_tpu/models/vqgan.py).

The block order, and so every state-dict key, is the reference's
(vqgan_arch.py:229-323), so released checkpoints load unchanged. Tap
indices are computed at construction with the JAX package's rules.
VectorQuantizer's forward runs the nearest-code search K3
(ops/vq.py); GumbelQuantizer is its stage-I alternative and
VQGANDiscriminator the PatchGAN of stages I and III.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from codeformer_tpu_torch.nn import blocks as nb
from codeformer_tpu_torch.nn.blocks import (AttnBlock, Conv2d, Downsample,
                                            GroupNorm32, QConv2d, ResBlock,
                                            Upsample, decoder_tail)
from codeformer_tpu_torch.ops import conv3x3 as cv
from codeformer_tpu_torch.ops import vq
from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY


class VectorQuantizer(nn.Module):
    """Nearest-neighbour codebook (vqgan_arch.py:24-84):
    `embedding.weight` (K, D), commitment loss, straight-through."""

    def __init__(self, codebook_size: int, emb_dim: int, beta: float = 0.25):
        super().__init__()
        self.codebook_size, self.emb_dim, self.beta = (codebook_size,
                                                       emb_dim, beta)
        self.embedding = nn.Embedding(codebook_size, emb_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / codebook_size,
                         1.0 / codebook_size)

    def forward(self, z: torch.Tensor):
        """z: (B, D, h, w) latents. Returns (z_q, loss, stats) as the JAX
        VectorQuantizer (codeformer_tpu/models/vqgan.py:46-79): distances,
        loss and statistics in fp32; z_q straight-through (its gradient
        w.r.t. z is the identity), in z's dtype; loss = mse(sg[z_q], z) +
        beta * mse(z_q, sg[z]); stats perplexity, min_encoding_indices
        (B*h*w,) in row-major (h, w) order, mean_distance (the mean of the
        full (tokens, codes) squared-distance matrix, vqgan_arch.py:42)."""
        b, d, h, w = z.shape
        z32 = z.float()
        z_flat = z32.permute(0, 2, 3, 1).reshape(-1, d)
        codebook = self.embedding.weight
        # the parameter itself, so K3 finds its kept operands again
        indices = vq.nearest_code_indices(z_flat.detach().contiguous(),
                                          codebook)
        z_q = vq.codebook_lookup(indices, codebook, torch.float32)
        z_q = z_q.reshape(b, h, w, d).permute(0, 3, 1, 2)
        loss = (torch.mean((z_q.detach() - z32) ** 2)
                + self.beta * torch.mean((z_q - z32.detach()) ** 2))
        z_q = z32 + (z_q - z32).detach()
        e_mean = torch.bincount(indices, minlength=self.codebook_size) \
            .float() / indices.numel()
        perplexity = torch.exp(-torch.sum(e_mean * torch.log(e_mean + 1e-10)))
        # mean_j,t (z_t . e_j) = (sum_t z_t) . (sum_j e_j) / (T K): the
        # mean of the matrix without forming it
        e32 = codebook.float()
        mean_distance = (z_flat.square().sum(1).mean()
                         + e32.square().sum(1).mean()
                         - 2.0 * (z_flat.sum(0) @ e32.sum(0))
                         / (z_flat.shape[0] * e32.shape[0]))
        stats = {'perplexity': perplexity, 'min_encoding_indices': indices,
                 'mean_distance': mean_distance}
        return z_q.to(z.dtype), loss, stats

    def get_codebook_feat(self, indices: torch.Tensor,
                          shape: Optional[Sequence[int]] = None,
                          dtype=None) -> torch.Tensor:
        """indices (B*T,) or (B, T) -> codebook rows; with an NHWC `shape`
        (B, h, w, D), an NCHW map in channels_last memory (as
        vqgan_arch.py:72-84)."""
        z_q = vq.codebook_lookup(indices.reshape(-1), self.embedding.weight,
                                 dtype)
        if shape is not None:
            z_q = z_q.reshape(shape).permute(0, 3, 1, 2)
        return z_q


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Gumbel(0, 1) noise of `shape`, fp32: -log(-log(u + 1e-20)) with u
    uniform on [1e-20, 1) drawn from `generator` (JAX vqgan.py:117-119)."""
    u = torch.empty(shape, device=device).uniform_(1e-20, 1.0,
                                                   generator=generator)
    return -torch.log(-torch.log(u + 1e-20))


class GumbelQuantizer(nn.Module):
    """Gumbel-softmax quantizer (vqgan_arch.py:87-114; JAX vqgan.py:95-140):
    a 1x1 projection to code logits, a (straight-through) Gumbel-softmax
    sample over the codes, and the sample's mix of `embed` rows."""

    def __init__(self, codebook_size: int, emb_dim: int, num_hiddens: int,
                 straight_through: bool = False, kl_weight: float = 5e-4,
                 temp_init: float = 1.0):
        super().__init__()
        self.codebook_size = codebook_size
        self.straight_through = straight_through
        self.kl_weight = kl_weight
        self.temperature = temp_init
        self.proj = Conv2d(num_hiddens, codebook_size, 1)
        self.embed = nn.Embedding(codebook_size, emb_dim)

    def forward(self, z: torch.Tensor, temperature: Optional[float] = None,
                generator: Optional[torch.Generator] = None):
        """z (B, D, h, w). In training mode the logits get Gumbel noise
        (from `generator`) and the sample is hard only with
        `straight_through`; in eval mode it is the hard softmax of the
        logits. Returns (z_q in z's dtype, the kl_weight KL term to the
        uniform prior, {'min_encoding_indices': (B, h, w)})."""
        hard = self.straight_through if self.training else True
        tau = self.temperature if temperature is None else temperature
        logits = self.proj(z).float()                      # (B, K, h, w)
        if self.training:
            logits_n = logits + gumbel_noise(logits.shape, generator,
                                             logits.device)
        else:
            logits_n = logits
        y_soft = torch.softmax(logits_n / tau, dim=1)
        indices = y_soft.argmax(1)
        if hard:
            y_hard = F.one_hot(indices, self.codebook_size).permute(
                0, 3, 1, 2).float()
            one_hot = y_hard + y_soft - y_soft.detach()
        else:
            one_hot = y_soft
        z_q = torch.einsum('bkhw,kd->bdhw', one_hot, self.embed.weight.float())
        qy = torch.softmax(logits, dim=1)
        diff = self.kl_weight * torch.mean(torch.sum(
            qy * torch.log(qy * self.codebook_size + 1e-10), dim=1))
        return z_q.to(z.dtype), diff, {'min_encoding_indices': indices}


def _build_encoder_blocks(nf, emb_dim, ch_mult, num_res_blocks, resolution,
                          attn_resolutions, remat=False):
    """Encoder blocks + {feature size: last-ResBlock index} taps, in the
    reference order (vqgan_arch.py:241-266). conv_in is quantizable
    (JAX's FastConv3x3), the last conv to emb_dim is not (JAX's nn.Conv)."""
    blocks = [QConv2d(3, nf, 3, padding=1)]
    taps: Dict[str, int] = {}
    curr_res = resolution
    in_ch_mult = (1,) + tuple(ch_mult)
    block_in = nf
    for i in range(len(ch_mult)):
        block_in = nf * in_ch_mult[i]
        block_out = nf * ch_mult[i]
        for _ in range(num_res_blocks):
            blocks.append(ResBlock(block_in, block_out, remat))
            block_in = block_out
            taps[str(curr_res)] = len(blocks) - 1
            if curr_res in attn_resolutions:
                blocks.append(AttnBlock(block_in))
        if i != len(ch_mult) - 1:
            blocks.append(Downsample(block_in))
            curr_res //= 2
    blocks.append(ResBlock(block_in, block_in, remat))
    blocks.append(AttnBlock(block_in))
    blocks.append(ResBlock(block_in, block_in, remat))
    blocks.append(GroupNorm32(block_in))
    blocks.append(Conv2d(block_in, emb_dim, 3, padding=1))
    return blocks, taps


def _build_generator_blocks(nf, emb_dim, ch_mult, num_res_blocks, resolution,
                            attn_resolutions, out_channels, remat=False):
    """Generator blocks + fuse taps (vqgan_arch.py:290-316): the first
    ResBlock of each stage, or the last one at attention resolutions
    (the reference's fuse table, codeformer_arch.py:206). conv_out is
    quantizable (JAX's FastConv3x3), the first conv is not (nn.Conv)."""
    num_resolutions = len(ch_mult)
    block_in = nf * ch_mult[-1]
    curr_res = resolution // 2 ** (num_resolutions - 1)
    blocks = [Conv2d(emb_dim, block_in, 3, padding=1),
              ResBlock(block_in, block_in, remat), AttnBlock(block_in),
              ResBlock(block_in, block_in, remat)]
    taps: Dict[str, int] = {}
    for i in reversed(range(num_resolutions)):
        block_out = nf * ch_mult[i]
        first_in_stage = True
        for _ in range(num_res_blocks):
            blocks.append(ResBlock(block_in, block_out, remat))
            block_in = block_out
            if first_in_stage or curr_res in attn_resolutions:
                taps[str(curr_res)] = len(blocks) - 1
                first_in_stage = False
            if curr_res in attn_resolutions:
                blocks.append(AttnBlock(block_in))
        if i != 0:
            blocks.append(Upsample(block_in))
            curr_res *= 2
    blocks.append(GroupNorm32(block_in))
    blocks.append(QConv2d(block_in, out_channels, 3, padding=1))
    return blocks, taps


class Encoder(nn.Module):
    """Image (B, 3, H, W) -> latents (B, emb_dim, h, w), plus the outputs
    of the tapped blocks by feature size (vqgan_arch.py:229-273).
    `remat`: every ResBlock recomputes its interior in the backward
    (nn/blocks.py ResBlock)."""

    def __init__(self, nf=64, emb_dim=256, ch_mult=(1, 2, 2, 4, 4, 8),
                 num_res_blocks=2, resolution=512, attn_resolutions=(16,),
                 remat: bool = False):
        super().__init__()
        blocks, self.tap_by_size = _build_encoder_blocks(
            nf, emb_dim, tuple(ch_mult), num_res_blocks, resolution,
            tuple(attn_resolutions), remat)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, tap_indices: Sequence[int] = ()
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        feats = {}
        taps = set(tap_indices)
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in taps:
                feats[str(x.shape[2])] = x
        return x, feats


class Generator(nn.Module):
    """Latents -> image (vqgan_arch.py:276-323). `fuse_fns` maps a block
    index to a callable applied to that block's output (CodeFormer's
    SFT fusion). With `use_kernels` the final GroupNorm + conv_out run as
    one K1 call, whose operands it keeps in eval mode
    (`kernel_operands`). `remat` as the Encoder's."""

    def __init__(self, nf=64, emb_dim=256, ch_mult=(1, 2, 2, 4, 4, 8),
                 num_res_blocks=2, resolution=512, attn_resolutions=(16,),
                 out_channels=3, remat: bool = False):
        super().__init__()
        self.use_kernels = True
        blocks, self.tap_by_size = _build_generator_blocks(
            nf, emb_dim, tuple(ch_mult), num_res_blocks, resolution,
            tuple(attn_resolutions), out_channels, remat)
        self.blocks = nn.ModuleList(blocks)
        self._operands = None    # (key, the tail's cv.DotsOperands)

    def kernel_operands(self):
        """The tail conv's cv.dots_operands, kept in eval mode
        (`kept_operands`); None in training mode."""
        conv = self.blocks[-1]
        return nb.kept_operands(
            self, (conv.weight, conv.bias),
            lambda: cv.dots_operands(conv.weight, conv.bias))

    def forward(self, x: torch.Tensor,
                fuse_fns: Optional[Dict[int, Callable]] = None
                ) -> torch.Tensor:
        fuse_fns = fuse_fns or {}
        n = len(self.blocks)
        for i in range(n - 2):
            x = self.blocks[i](x)
            if i in fuse_fns:
                x = fuse_fns[i](x)
        kept = self.kernel_operands() \
            if self.use_kernels and nb.on_card(x) else None
        return decoder_tail(self.blocks[n - 2], self.blocks[n - 1], x,
                            self.use_kernels, prepared=kept)


@ARCH_REGISTRY.register()
class VQAutoEncoder(nn.Module):
    """The VQGAN backbone: encoder, codebook, generator
    (vqgan_arch.py:326-389), with the 'nearest' quantizer (K3) or the
    'gumbel' one. `remat` (the trainers set it from `train: remat:
    true`): the encoder's and the generator's ResBlocks recompute their
    interiors in the backward; the state dict is the same."""

    def __init__(self, img_size=512, nf=64, ch_mult=(1, 2, 2, 4, 4, 8),
                 res_blocks=2, attn_resolutions=(16,), codebook_size=1024,
                 emb_dim=256, quantizer: str = 'nearest', beta: float = 0.25,
                 gumbel_straight_through: bool = False,
                 gumbel_kl_weight: float = 1e-8, remat: bool = False):
        super().__init__()
        self.ch_mult, self.emb_dim = tuple(ch_mult), emb_dim
        self.remat = remat
        self.encoder = Encoder(nf, emb_dim, ch_mult, res_blocks, img_size,
                               attn_resolutions, remat)
        if quantizer == 'nearest':
            self.quantize = VectorQuantizer(codebook_size, emb_dim, beta)
        elif quantizer == 'gumbel':
            self.quantize = GumbelQuantizer(
                codebook_size, emb_dim, emb_dim, gumbel_straight_through,
                gumbel_kl_weight)
        else:
            raise ValueError(f'unknown quantizer {quantizer!r}')
        self.generator = Generator(nf, emb_dim, ch_mult, res_blocks,
                                   img_size, attn_resolutions, remat=remat)

    def forward(self, x: torch.Tensor, **quant_kwargs):
        """Encode -> quantize -> decode (codeformer_tpu/models/vqgan.py:
        359-363): (reconstruction, codebook_loss, quantizer stats).
        `quant_kwargs` go to the Gumbel quantizer (temperature,
        generator)."""
        x, _ = self.encoder(x)
        quant, codebook_loss, quant_stats = self.quantize(x, **quant_kwargs)
        return self.generator(quant), codebook_loss, quant_stats


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's arithmetic (the JAX discriminator's
    nn.BatchNorm): fp32 batch statistics with the biased variance
    E[x^2] - E[x]^2 (clipped at 0), running statistics updated with that
    same biased variance (PyTorch's own takes the unbiased one), and
    (x - mean) * (rsqrt(var + eps) * weight) + bias in fp32, out in the
    input's dtype. momentum 0.1 here is flax's 0.9.

    `sync_stats` (the trainers set it under data parallelism): the batch
    statistics are those of the global batch, the fp32 sums [sum x, sum
    x^2] all-reduced over the processes through an all-reduce autograd
    differentiates (its backward sums the gradients), as JAX's jit over
    the global batch takes them."""

    sync_stats = False

    def _batch_stats(self, xf: torch.Tensor):
        """(mean, E[x^2] - mean^2) of the batch from its fp32 sums; under
        `sync_stats` the sums of every process's batch."""
        sums = torch.stack([xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3))])
        n = xf.numel() // xf.shape[1]
        if self.sync_stats:
            from codeformer_tpu_torch import parallel
            sums = parallel.all_reduce_sum_autograd(sums)
            n *= parallel.get_dist_info()[1]
        mean = sums[0] / n
        return mean, sums[1] / n - mean.square()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean, var = self._batch_stats(xf)
            var = var.clamp_min(0)
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(
                    mean, alpha=self.momentum)
                self.running_var.mul_(1 - self.momentum).add_(
                    var, alpha=self.momentum)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) \
            + self.bias.view(1, -1, 1, 1)
        return y.to(x.dtype)


@ARCH_REGISTRY.register()
class VQGANDiscriminator(nn.Module):
    """PatchGAN discriminator (vqgan_arch.py:394-434; JAX vqgan.py:
    366-407): 4x4 stride-2 convs with BatchNorm and LeakyReLU(0.2) down to
    a one-channel logit map. `main` is the reference's nn.Sequential, so
    its `.pth` names (`main.N.*`) load positionally. Convs compute in the
    input's dtype."""

    def __init__(self, nc: int = 3, ndf: int = 64, n_layers: int = 4):
        super().__init__()
        layers = [Conv2d(nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers):
            prev, mult = mult, min(2 ** n, 8)
            layers += [Conv2d(ndf * prev, ndf * mult, 4, 2, 1, bias=False),
                       BatchNorm2d(ndf * mult), nn.LeakyReLU(0.2)]
        prev, mult = mult, min(2 ** n_layers, 8)
        layers += [Conv2d(ndf * prev, ndf * mult, 4, 1, 1, bias=False),
                   BatchNorm2d(ndf * mult), nn.LeakyReLU(0.2),
                   Conv2d(ndf * mult, 1, 4, 1, 1)]
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)
