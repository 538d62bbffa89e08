"""Graph-faithful PyTorch replicas of the upstream ``ns3_codec`` FACodec
encoder and decoder, with their state-dict naming: ``WNConv1d`` as torch's
weight norm (``weight_g`` / ``weight_v``), ``Snake1d`` alpha (1, C, 1),
``block.{i}`` / ``model.{i}`` / ``quantizer.{b}.quantizers.{j}`` /
``timbre_encoder.layers.{i}`` keys, ``MultiheadAttention``'s
``in_proj_weight`` (reference: data_utils/audio_encoder.py:143-176).

They are written from the upstream graph, not from the port's converter
(``models/facodec.py`` ``convert_torch_facodec``), so that the key inventory
``tools/gen_manifests.py`` takes from them can catch drift in that
converter.  The repository's FACodec conversion tests build the same
classes; these take the port's ``config.CodecConfig``.
"""
import math

import torch
import torch.nn as tnn
import torch.nn.functional as F


def WNConv1d(*args, **kwargs):
    return tnn.utils.weight_norm(tnn.Conv1d(*args, **kwargs))


def WNConvTranspose1d(*args, **kwargs):
    return tnn.utils.weight_norm(tnn.ConvTranspose1d(*args, **kwargs))


class Snake1d(tnn.Module):
    def __init__(self, dim):
        super().__init__()
        self.alpha = tnn.Parameter(torch.rand(1, dim, 1) + 0.5)

    def forward(self, x):
        return x + (self.alpha + 1e-9).reciprocal() * torch.sin(self.alpha * x).pow(2)


class TResidualUnit(tnn.Module):
    def __init__(self, dim, dilation):
        super().__init__()
        pad = ((7 - 1) * dilation) // 2
        self.block = tnn.Sequential(
            Snake1d(dim),
            WNConv1d(dim, dim, kernel_size=7, dilation=dilation, padding=pad),
            Snake1d(dim),
            WNConv1d(dim, dim, kernel_size=1),
        )

    def forward(self, x):
        return x + self.block(x)


class TEncoderBlock(tnn.Module):
    def __init__(self, dim, stride):
        super().__init__()
        self.block = tnn.Sequential(
            TResidualUnit(dim // 2, 1),
            TResidualUnit(dim // 2, 3),
            TResidualUnit(dim // 2, 9),
            Snake1d(dim // 2),
            WNConv1d(dim // 2, dim, kernel_size=2 * stride, stride=stride,
                     padding=math.ceil(stride / 2)),
        )

    def forward(self, x):
        return self.block(x)


class TEncoder(tnn.Module):
    """Upstream FACodecEncoder: keys block.0 .. block.{n+2}."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg.ngf
        blocks = [WNConv1d(1, d, kernel_size=7, padding=3)]
        for stride in cfg.up_ratios:
            d *= 2
            blocks += [TEncoderBlock(d, stride)]
        blocks += [Snake1d(d), WNConv1d(d, cfg.latent_dim, kernel_size=3, padding=1)]
        self.block = tnn.Sequential(*blocks)

    def forward(self, x):
        return self.block(x)


class TDecoderBlock(tnn.Module):
    def __init__(self, c_in, c_out, stride):
        super().__init__()
        self.block = tnn.Sequential(
            Snake1d(c_in),
            WNConvTranspose1d(c_in, c_out, kernel_size=2 * stride, stride=stride,
                              padding=math.ceil(stride / 2),
                              output_padding=stride % 2),
            TResidualUnit(c_out, 1),
            TResidualUnit(c_out, 3),
            TResidualUnit(c_out, 9),
        )

    def forward(self, x):
        return self.block(x)


class TFVQ(tnn.Module):
    """Upstream FactorizedVectorQuantize (inference path)."""

    def __init__(self, latent_dim, codebook_size, codebook_dim):
        super().__init__()
        self.in_proj = WNConv1d(latent_dim, codebook_dim, kernel_size=1)
        self.out_proj = WNConv1d(codebook_dim, latent_dim, kernel_size=1)
        self.codebook = tnn.Embedding(codebook_size, codebook_dim)

    def forward(self, z):  # z: (B, D, T)
        B, _, T = z.shape
        z_e = self.in_proj(z)  # (B, cd, T)
        enc = F.normalize(z_e.permute(0, 2, 1).reshape(B * T, -1))
        cb = F.normalize(self.codebook.weight)
        dist = (
            enc.pow(2).sum(1, keepdim=True)
            - 2 * enc @ cb.t()
            + cb.pow(2).sum(1, keepdim=True).t()
        )
        ids = (-dist).max(1)[1].view(B, T)
        z_q = self.codebook(ids).permute(0, 2, 1)  # unnormalized lookup
        return self.out_proj(z_q), ids


class TRVQ(tnn.Module):
    def __init__(self, num_q, latent_dim, codebook_size, codebook_dim):
        super().__init__()
        self.quantizers = tnn.ModuleList(
            [TFVQ(latent_dim, codebook_size, codebook_dim) for _ in range(num_q)]
        )

    def forward(self, z):
        residual, total, ids = z, 0.0, []
        for q in self.quantizers:
            zq, i = q(residual)
            residual = residual - zq
            total = total + zq
            ids.append(i)
        return total, torch.stack(ids, dim=0)


class TFFN(tnn.Module):
    def __init__(self, hidden, filter_size, kernel_size=5):
        super().__init__()
        self.ffn_1 = tnn.Conv1d(hidden, filter_size, kernel_size, padding=kernel_size // 2)
        self.ffn_2 = tnn.Linear(filter_size, hidden)

    def forward(self, x):  # (B, T, H)
        h = self.ffn_1(x.permute(0, 2, 1)).permute(0, 2, 1)
        return self.ffn_2(F.relu(h))


class TTimbreLayer(tnn.Module):
    def __init__(self, hidden, heads, filter_size):
        super().__init__()
        self.ln_1 = tnn.LayerNorm(hidden)
        self.self_attn = tnn.MultiheadAttention(hidden, heads, batch_first=True)
        self.ln_2 = tnn.LayerNorm(hidden)
        self.ffn = TFFN(hidden, filter_size)

    def forward(self, x):
        h = self.ln_1(x)
        attn, _ = self.self_attn(h, h, h, need_weights=False)
        x = x + attn
        return x + self.ffn(self.ln_2(x))


class TTimbreEncoder(tnn.Module):
    def __init__(self, hidden, heads=4, filter_size=1024, n_layers=4):
        super().__init__()
        self.layers = tnn.ModuleList(
            [TTimbreLayer(hidden, heads, filter_size) for _ in range(n_layers)]
        )
        self.last_ln = tnn.LayerNorm(hidden)

    def forward(self, x):  # (B, T, H)
        for layer in self.layers:
            x = layer(x)
        return self.last_ln(x)


class TDecoder(tnn.Module):
    """Upstream FACodecDecoder param container: quantizer / timbre_encoder /
    timbre_linear / timbre_norm / model."""

    def __init__(self, cfg):
        super().__init__()
        self.quantizer = tnn.ModuleList([
            TRVQ(cfg.vq_num_q_p, cfg.latent_dim, cfg.codebook_size, cfg.codebook_dim),
            TRVQ(cfg.vq_num_q_c, cfg.latent_dim, cfg.codebook_size, cfg.codebook_dim),
            TRVQ(cfg.vq_num_q_r, cfg.latent_dim, cfg.codebook_size, cfg.codebook_dim),
        ])
        self.timbre_encoder = TTimbreEncoder(cfg.latent_dim)
        self.timbre_linear = tnn.Linear(cfg.latent_dim, cfg.latent_dim * 2)
        self.timbre_linear.bias.data[: cfg.latent_dim] = 1
        self.timbre_linear.bias.data[cfg.latent_dim :] = 0
        self.timbre_norm = tnn.LayerNorm(cfg.latent_dim, elementwise_affine=False)
        ch = cfg.decoder_initial_channels
        model = [WNConv1d(cfg.latent_dim, ch, kernel_size=7, padding=3)]
        for stride in reversed(cfg.up_ratios):
            model += [TDecoderBlock(ch, ch // 2, stride)]
            ch //= 2
        model += [Snake1d(ch), WNConv1d(ch, 1, kernel_size=7, padding=3), tnn.Tanh()]
        self.model = tnn.Sequential(*model)

    def quantize(self, x):  # x: (B, D, T) latents
        qp, idp = self.quantizer[0](x)
        qc, idc = self.quantizer[1](x - qp)
        qr, idr = self.quantizer[2](x - qp - qc)
        # stream order [Qp, Qr..., Qc] (the framework's pinned contract)
        return qp + qc + qr, torch.cat([idp, idr, idc], dim=0)

    def forward(self, x):  # full inference: latents -> (recon, ids, spk)
        quantized, ids = self.quantize(x)
        spk = self.timbre_encoder(x.transpose(1, 2)).mean(dim=1)
        style = self.timbre_linear(spk).unsqueeze(2)  # (B, 2D, 1)
        gamma, beta = style.chunk(2, 1)
        z = self.timbre_norm(quantized.transpose(1, 2)).transpose(1, 2)
        z = z * gamma + beta
        return self.model(z), ids, spk
