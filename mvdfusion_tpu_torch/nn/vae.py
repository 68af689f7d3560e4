"""SD v1 AutoencoderKL, NHWC (torch counterpart of mvdfusion_tpu/nn/vae.py).

encode takes the posterior mode (the mean half of the moments); the
downsample pads (0, 1, 0, 1) then convolves with stride 2; the decoder uses
plain fp32 GroupNorm. Names follow the reference's encoder.down.{l}.block.{i},
mid.block_1 / attn_1 / block_2, decoder.up.{l}, quant_conv, post_quant_conv.

The GroupNorms of maps above 2^20 elements an image take the tiled form
(ops/groupnorm.py, K7) on the card always, and on the CPU under the
reference's MVDF_GN_TILED=1 (ops/groupnorm.py::gn_route). MVDF_CONV3X3=1,
off by default as in the reference, sends the ResBlocks of maps of at least
64^2 through the fused conv (ops/conv3x3.py, K8).

Under tensor parallelism (parallel/mesh.py) each conv is split by its output
features and gathered after it (nn/layers.py::Conv2d), so K7 sees whole
maps; K8 reads its weights gathered whole (parallel/tensor.py::whole).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mvdfusion_tpu_torch.nn.layers import Conv1x1, Conv2d, GroupNorm32, dot_attention
from mvdfusion_tpu_torch.ops import conv3x3
from mvdfusion_tpu_torch.ops.image import nearest_upsample2x
from mvdfusion_tpu_torch.parallel.tensor import whole


class VAEResnetBlock(nn.Module):
    """GroupNorm32+SiLU -> conv -> GroupNorm32+SiLU -> conv, + x (or its 1x1
    nin_shortcut). Where the reference's gate passes on the input and the
    output map (MVDF_CONV3X3=1, ops/conv3x3.py) it takes the fused branch of
    the reference (mvdfusion_tpu/nn/vae.py:68-85): a folded-GN statistics pass
    and one fused GN-affine + SiLU + conv kernel per conv, the residual added
    in the second conv's epilogue. The gate is called through the module
    (conv3x3.should_fuse_conv3x3) so that a test can patch it."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm32(cin, eps=1e-6, act="silu")
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm32(cout, eps=1e-6, act="silu")
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = Conv1x1(cin, cout) if cin != cout else None

    def forward(self, x):
        B, H, W, _ = x.shape
        cout = self.conv1.out_channels
        if not (conv3x3.should_fuse_conv3x3(x.shape) and conv3x3.should_fuse_conv3x3((B, H, W, cout))):
            h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
            return (self.nin_shortcut(x) if self.nin_shortcut is not None else x) + h
        dt = self.conv1.weight.dtype
        zrow = torch.zeros(B, cout, dtype=torch.float32, device=x.device)
        a1, b1 = conv3x3.gn_fold_affine(x.reshape(B, H * W, -1), self.norm1.weight, self.norm1.bias, 32, 1e-6)
        h = conv3x3.gn_silu_conv3x3(x.to(dt), a1, b1, whole(self.conv1.weight), self.conv1.bias, zrow, None)
        a2, b2 = conv3x3.gn_fold_affine(h.reshape(B, H * W, -1), self.norm2.weight, self.norm2.bias, 32, 1e-6)
        res = self.nin_shortcut(x) if self.nin_shortcut is not None else x.to(dt)
        return conv3x3.gn_silu_conv3x3(h, a2, b2, whole(self.conv2.weight), self.conv2.bias, zrow, res)


class VAEAttnBlock(nn.Module):
    """Single-head bottleneck self-attention with 1x1 q/k/v/proj_out."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (Conv1x1(ch, ch) for _ in range(4))

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.norm(x)
        q, k, v = (m(h).reshape(B, H * W, 1, C) for m in (self.q, self.k, self.v))
        return x + self.proj_out(dot_attention(q, k, v, C**-0.5).reshape(B, H, W, C))


class _Down(nn.Module):
    def __init__(self, cin: int, cout: int, nrb: int, downsample: bool):
        super().__init__()
        self.block = nn.ModuleList([VAEResnetBlock(cin if i == 0 else cout, cout) for i in range(nrb)])
        if downsample:
            self.downsample = nn.Module()
            self.downsample.conv = Conv2d(cout, cout, 3, stride=2, padding=0)


class _Up(nn.Module):
    def __init__(self, cin: int, cout: int, nrb: int, upsample: bool):
        super().__init__()
        self.block = nn.ModuleList([VAEResnetBlock(cin if i == 0 else cout, cout) for i in range(nrb + 1)])
        if upsample:
            self.upsample = nn.Module()
            self.upsample.conv = Conv2d(cout, cout, 3, padding=1)


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = VAEResnetBlock(ch, ch)
        self.attn_1 = VAEAttnBlock(ch)
        self.block_2 = VAEResnetBlock(ch, ch)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder(nn.Module):
    def __init__(self, ch=128, ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks=2, z_channels=4):
        super().__init__()
        self.conv_in = Conv2d(3, ch, 3, padding=1)
        cin = ch
        self.down = nn.ModuleList()
        for level, m in enumerate(ch_mult):
            self.down.append(_Down(cin, ch * m, num_res_blocks, level != len(ch_mult) - 1))
            cin = ch * m
        self.mid = _Mid(cin)
        self.norm_out = GroupNorm32(cin, eps=1e-6, act="silu")
        self.conv_out = Conv2d(cin, 2 * z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for d in self.down:
            for b in d.block:
                h = b(h)
            if hasattr(d, "downsample"):
                h = d.downsample.conv(F.pad(h, (0, 0, 0, 1, 0, 1)))  # NHWC: pad W then H by (0, 1)
        return self.conv_out(self.norm_out(self.mid(h)))


class Decoder(nn.Module):
    def __init__(self, ch=128, out_ch=3, ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks=2, z_channels=4):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        ups = [None] * len(ch_mult)
        for level in reversed(range(len(ch_mult))):
            ups[level] = _Up(block_in, ch * ch_mult[level], num_res_blocks, level != 0)
            block_in = ch * ch_mult[level]
        self.up = nn.ModuleList(ups)
        self.norm_out = GroupNorm32(block_in, eps=1e-6, act="silu")
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(range(len(self.up))):
            for b in self.up[level].block:
                h = b(h)
            if level != 0:
                h = self.up[level].upsample.conv(nearest_upsample2x(h))
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, embed_dim=4, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4):
        super().__init__()
        self.embed_dim = embed_dim
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, z_channels)
        self.decoder = Decoder(ch, 3, ch_mult, num_res_blocks, z_channels)
        self.quant_conv = Conv1x1(2 * z_channels, 2 * embed_dim)
        self.post_quant_conv = Conv1x1(embed_dim, z_channels)

    def encode_mode(self, x):
        """[-1,1] NHWC image -> latent posterior mean."""
        return self.quant_conv(self.encoder(x))[..., : self.embed_dim]

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))
