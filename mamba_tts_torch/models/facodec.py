"""FACodec-compatible factorized neural audio codec — counterpart of
``mamba_tts_tpu/models/facodec.py``.

    wave (B, T) @16 kHz --encode--> latents @80 Hz (hop 200 = prod(2,4,5,5))
        --factorize + cosine VQ--> ids (num_q, B, T_f) + speaker embedding
    ids --decode--> wave (B, T_f * hop)

Convolutions run channels-first (B, C, T), PyTorch's layout; the public
methods keep the JAX package's shapes.  Weight-normed convs are held fused.
Stream order is [prosody, residual x3, content].  Attribute names follow the
Flax parameter tree so the weight bridge maps them one-to-one.

:func:`convert_torch_facodec` / :func:`load_torch_facodec` map the released
``ns3_facodec_{encoder,decoder}.bin`` state dicts (upstream ``ns3_codec``
naming) onto that tree as numpy arrays; ``bridge.facodec_from_params`` then
loads it and checks every leaf and shape.

Training (``train/train_codec.py``): ``FACodec.forward(wav, losses)`` gives
(recon, ids, spk) and appends each quantizer's VQ loss (codebook term plus
0.25 x commitment term) to the list ``losses``, where the JAX package sows
them; the quantizers pass the gradient straight through to the encoder.
:func:`grad_reverse` is the gradient-reversal layer of the upstream
adversarial heads, which neither package builds.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_tts_torch.config import CodecConfig
from mamba_tts_torch.models.layers import Conv, Dense, LayerNorm, normal_init


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


def grad_reverse(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, negated gradient backward (GRL)."""
    return _GradReverse.apply(x)


class Snake(nn.Module):
    """x + sin^2(a x) / (a + 1e-9), per-channel a; channels-first input."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels))

    def init_weights(self, g: torch.Generator) -> None:
        nn.init.ones_(self.alpha)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.alpha[None, :, None].to(x.dtype)
        return x + torch.sin(a * x) ** 2 / (a + 1e-9)


class ResidualUnit(nn.Module):
    """Snake -> conv k7 (dilated) -> Snake -> conv k1, plus the skip."""

    def __init__(self, channels: int, dilation: int):
        super().__init__()
        pad = 3 * dilation
        self.snake1 = Snake(channels)
        self.conv1 = Conv(channels, channels, 7, dilation=dilation, padding=(pad, pad))
        self.snake2 = Snake(channels)
        self.conv2 = Conv(channels, channels, 1, padding=(0, 0))

    def forward(self, x):
        return x + self.conv2(self.snake2(self.conv1(self.snake1(x))))


class EncoderBlock(nn.Module):
    """3 dilated residual units -> Snake -> strided downsample conv."""

    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        for i, d in enumerate((1, 3, 9)):
            self.add_module(f"res_{i}", ResidualUnit(c_in, d))
        self.snake = Snake(c_in)
        p = (stride + 1) // 2
        self.down = Conv(c_in, c_out, 2 * stride, stride=stride, padding=(p, p))

    def forward(self, x):
        for i in range(3):
            x = getattr(self, f"res_{i}")(x)
        return self.down(self.snake(x))


class CodecEncoder(nn.Module):
    """wave (B, T) -> latents (B, latent_dim, T // hop), channels-first."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.ngf
        self.stem = Conv(1, ch, 7, padding=(3, 3))
        for i, r in enumerate(cfg.up_ratios):
            self.add_module(f"block_{i}", EncoderBlock(ch, 2 * ch, r))
            ch *= 2
        self.snake_out = Snake(ch)
        self.head = Conv(ch, cfg.latent_dim, 3, padding=(1, 1))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.stem(wav[:, None, :])
        for i in range(len(self.cfg.up_ratios)):
            x = getattr(self, f"block_{i}")(x)
        return self.head(self.snake_out(x))


class ConvTranspose1dTorch(nn.ConvTranspose1d):
    """Upsampling transposed conv: kernel 2*stride, padding ceil(stride/2),
    output_padding stride % 2, so the output length is T * stride.  The Flax
    tree stores this kernel as (k, in, out) flipped along k; the bridge
    un-flips it into ``weight`` (in, out, k)."""

    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__(c_in, c_out, 2 * stride, stride=stride, padding=(stride + 1) // 2,
                         output_padding=stride % 2)

    def init_weights(self, g: torch.Generator) -> None:
        normal_init(self.weight, 1.0 / math.sqrt(self.in_channels * self.kernel_size[0]), g)
        nn.init.zeros_(self.bias)


class DecoderBlock(nn.Module):
    """Snake -> transposed-conv upsample -> 3 dilated residual units."""

    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.snake = Snake(c_in)
        self.up = ConvTranspose1dTorch(c_in, c_out, stride)
        for i, d in enumerate((1, 3, 9)):
            self.add_module(f"res_{i}", ResidualUnit(c_out, d))

    def forward(self, x):
        x = self.up(self.snake(x))
        for i in range(3):
            x = getattr(self, f"res_{i}")(x)
        return x


class CodecDecoder(nn.Module):
    """latents (B, T_f, latent_dim) + spk (B, spk_dim) -> wave (B, T_f * hop).
    Timbre FiLM: LayerNorm (no affine) of the latents, gamma/beta from
    ``timbre_linear(spk)``."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        c = self.cfg = cfg
        self.timbre_norm = LayerNorm(c.latent_dim, eps=1e-5, affine=False)
        self.timbre_linear = Dense(c.spk_dim, 2 * c.latent_dim)
        ch = c.decoder_initial_channels
        self.stem = Conv(c.latent_dim, ch, 7, padding=(3, 3))
        for i, r in enumerate(reversed(c.up_ratios)):
            self.add_module(f"block_{i}", DecoderBlock(ch, ch // 2, r))
            ch //= 2
        self.snake_out = Snake(ch)
        self.head = Conv(ch, 1, 7, padding=(3, 3))

    def init_weights(self, g: torch.Generator) -> None:
        """FiLM bias so that gamma = 1 and beta = 0 at init."""
        d = self.cfg.latent_dim
        with torch.no_grad():
            self.timbre_linear.bias.copy_(torch.cat([torch.ones(d), torch.zeros(d)]))

    def forward(self, z: torch.Tensor, spk: Optional[torch.Tensor] = None) -> torch.Tensor:
        if spk is not None:
            gamma, beta = self.timbre_linear(spk).chunk(2, dim=-1)
            z = self.timbre_norm(z) * gamma[:, None, :] + beta[:, None, :]
        x = self.stem(z.transpose(1, 2))
        for i in range(len(self.cfg.up_ratios)):
            x = getattr(self, f"block_{i}")(x)
        x = self.head(self.snake_out(x))
        return torch.tanh(x)[:, 0, :]


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) over the last axis, in f32."""
    xf = x.to(torch.float32)
    n = torch.sqrt((xf ** 2).sum(dim=-1, keepdim=True))
    return (xf / torch.clamp(n, min=eps)).to(x.dtype)


class VectorQuantizer(nn.Module):
    """1x1 in_proj to codebook_dim -> cosine nearest code -> codebook row,
    passed straight through -> 1x1 out_proj back to latent_dim.
    Channels-last (B, T, D)."""

    def __init__(self, codebook_size: int, codebook_dim: int, latent_dim: int):
        super().__init__()
        self.in_proj = Dense(latent_dim, codebook_dim)
        self.codebook = nn.Parameter(torch.zeros(codebook_size, codebook_dim))
        self.out_proj = Dense(codebook_dim, latent_dim)

    def init_weights(self, g: torch.Generator) -> None:
        normal_init(self.codebook, 1.0, g)

    def forward(self, z: torch.Tensor, losses: Optional[List[torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(quantized latent, ids (B, T)); appends the VQ loss to ``losses``."""
        down = self.in_proj(z)
        e = _l2_normalize(down.to(torch.float32))
        cbn = _l2_normalize(self.codebook)
        ids = torch.argmax(torch.matmul(e, cbn.T), dim=-1)  # (B, T)
        quant_raw = self.codebook[ids].to(down.dtype)
        if losses is not None:
            # the codebook term pulls codes to encodings, the commitment term the reverse
            codebook_loss = ((quant_raw - down.detach()) ** 2).mean()
            commit_loss = ((down - quant_raw.detach()) ** 2).mean()
            losses.append(codebook_loss + 0.25 * commit_loss)
        # straight through: the code's value, the encoder's gradient (and the
        # JAX graph's rounding of the sum)
        return self.out_proj(down + (quant_raw - down).detach()), ids

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        return self.codebook[ids] @ self.out_proj.weight.T + self.out_proj.bias


class ResidualVQ(nn.Module):
    """num_q-level residual VQ: summed quantized latent + (num_q, B, T) ids."""

    def __init__(self, num_q: int, codebook_size: int, codebook_dim: int, latent_dim: int):
        super().__init__()
        self.num_q = num_q
        for i in range(num_q):
            self.add_module(f"vq_{i}", VectorQuantizer(codebook_size, codebook_dim, latent_dim))

    def _vqs(self):
        return [getattr(self, f"vq_{i}") for i in range(self.num_q)]

    def forward(self, z: torch.Tensor, losses: Optional[List[torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        residual, total, ids = z, torch.zeros_like(z), []
        for vq in self._vqs():
            q, i = vq(residual, losses)
            residual = residual - q
            total = total + q
            ids.append(i)
        return total, torch.stack(ids, dim=0)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        total = None
        for i, vq in enumerate(self._vqs()):
            q = vq.lookup(ids[i])
            total = q if total is None else total + q
        return total


class TimbreFFN(nn.Module):
    """Conv(k5) -> ReLU -> Linear over (B, T, D)."""

    def __init__(self, hidden: int, filter_size: int, kernel_size: int = 5):
        super().__init__()
        p = kernel_size // 2
        self.ffn_1 = Conv(hidden, filter_size, kernel_size, padding=(p, p))
        self.ffn_2 = Dense(filter_size, hidden)

    def forward(self, x):
        return self.ffn_2(F.relu(self.ffn_1(x.transpose(1, 2))).transpose(1, 2))


class TimbreEncoderLayer(nn.Module):
    """Pre-LN: x + MHA(ln_1(x)); x + FFN(ln_2(x))."""

    def __init__(self, hidden: int, heads: int, filter_size: int):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        self.ln_1 = LayerNorm(hidden, eps=1e-5)
        self.q_proj = Dense(hidden, hidden)
        self.k_proj = Dense(hidden, hidden)
        self.v_proj = Dense(hidden, hidden)
        self.o_proj = Dense(hidden, hidden)
        self.ln_2 = LayerNorm(hidden, eps=1e-5)
        self.ffn = TimbreFFN(hidden, filter_size)

    def forward(self, x):
        B, T, _ = x.shape
        hd = self.hidden // self.heads
        h = self.ln_1(x)

        def heads(t):
            return t.reshape(B, T, self.heads, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj(h)), heads(self.k_proj(h)), heads(self.v_proj(h))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        probs = torch.softmax(logits / math.sqrt(hd), dim=-1).to(v.dtype)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, self.hidden)
        x = x + self.o_proj(attn)
        return x + self.ffn(self.ln_2(x))


class TimbreExtractor(nn.Module):
    """Transformer over latents, mean-pooled -> (B, spk_dim); an output
    projection exists only when spk_dim != latent_dim."""

    def __init__(self, cfg: CodecConfig, n_layers: int = 4, n_heads: int = 4,
                 filter_size: int = 1024):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer_{i}", TimbreEncoderLayer(cfg.latent_dim, n_heads, filter_size))
        self.last_ln = LayerNorm(cfg.latent_dim, eps=1e-5)
        self.out = Dense(cfg.latent_dim, cfg.spk_dim) if cfg.spk_dim != cfg.latent_dim else None

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x)
        pooled = self.last_ln(x).mean(dim=1)
        return pooled if self.out is None else self.out(pooled)


class FACodec(nn.Module):
    """encode(wav) -> (ids (num_q, B, T_f), spk); decode(ids, spk) -> wave;
    forward(wav, losses) -> (recon, ids, spk) for training."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        c = self.cfg = cfg
        self.encoder = CodecEncoder(c)
        self.timbre = TimbreExtractor(c)
        self.vq_prosody = ResidualVQ(c.vq_num_q_p, c.codebook_size, c.codebook_dim, c.latent_dim)
        self.vq_content = ResidualVQ(c.vq_num_q_c, c.codebook_size, c.codebook_dim, c.latent_dim)
        self.vq_residual = ResidualVQ(c.vq_num_q_r, c.codebook_size, c.codebook_dim, c.latent_dim)
        self.decoder = CodecDecoder(c)

    def _factorize(self, wav, losses: Optional[List[torch.Tensor]] = None):
        h = self.encoder(wav).transpose(1, 2)  # (B, T_f, D)
        spk = self.timbre(h)
        qp, idp = self.vq_prosody(h, losses)
        qc, idc = self.vq_content(h - qp, losses)
        qr, idr = self.vq_residual(h - qp - qc, losses)
        return torch.cat([idp, idr, idc], dim=0), qp + qc + qr, spk

    def encode(self, wav: torch.Tensor):
        ids, _, spk = self._factorize(wav)
        return ids, spk

    def latents_from_ids(self, vq_ids: torch.Tensor) -> torch.Tensor:
        """(num_q, B, T_f) in [Qp, Qr x3, Qc] order -> summed latents."""
        c = self.cfg
        p, r, ct = c.vq_num_q_p, c.vq_num_q_r, c.vq_num_q_c
        qp = self.vq_prosody.lookup(vq_ids[:p])
        qr = self.vq_residual.lookup(vq_ids[p:p + r])
        qc = self.vq_content.lookup(vq_ids[p + r:p + r + ct])
        return qp + qr + qc

    def decode(self, vq_ids: torch.Tensor, spk: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decoder(self.latents_from_ids(vq_ids), spk)

    def forward(self, wav: torch.Tensor, losses: Optional[List[torch.Tensor]] = None):
        """(recon wave, ids, spk), as the JAX ``__call__``; each quantizer's VQ
        loss is appended to ``losses`` (5 at the default config)."""
        ids, quantized, spk = self._factorize(wav, losses)
        return self.decoder(quantized, spk), ids, spk


# --------------------------------------------------------------------------
# released torch state dicts (ns3_codec naming) -> the Flax-layout tree
# --------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def _fused_wn(sd: Dict, prefix: str) -> np.ndarray:
    """torch weight norm fused: w = g * v / ||v||, the norm over the axes
    where g is singleton (``dim=0`` keeps the out-channel axis).  A layer
    without weight norm gives its plain ``.weight``."""
    if prefix + ".weight" in sd:
        return _np(sd[prefix + ".weight"])
    g = _np(sd[prefix + ".weight_g"])
    v = _np(sd[prefix + ".weight_v"])
    axes = tuple(i for i, n in enumerate(g.shape) if n == 1)
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


class _Converter:
    """Collects the Flax-layout leaves, one torch module at a time."""

    def __init__(self):
        self.out: Dict = {}

    def _set(self, path: Sequence[str], value: np.ndarray):
        d = self.out
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = value

    def _bias(self, sd, tkey, fpath):
        if tkey + ".bias" in sd:
            self._set([*fpath, "bias"], _np(sd[tkey + ".bias"]))

    def conv(self, sd, tkey, *fpath):
        """Conv1d (out, in, k) -> kernel (k, in, out)."""
        self._set([*fpath, "kernel"], _fused_wn(sd, tkey).transpose(2, 1, 0))
        self._bias(sd, tkey, fpath)

    def conv_t(self, sd, tkey, *fpath):
        """ConvTranspose1d (in, out, k) -> kernel (k, in, out), flipped along
        k (the JAX package's ``ConvTranspose1dTorch`` layout)."""
        w = _fused_wn(sd, tkey)
        self._set([*fpath, "kernel"], w[:, :, ::-1].transpose(2, 0, 1).copy())
        self._bias(sd, tkey, fpath)

    def conv1x1_as_dense(self, sd, tkey, *fpath):
        """1x1 Conv1d (out, in, 1) -> Dense kernel (in, out)."""
        self._set([*fpath, "kernel"], _fused_wn(sd, tkey)[:, :, 0].T)
        self._bias(sd, tkey, fpath)

    def dense(self, sd, tkey, *fpath):
        self._set([*fpath, "kernel"], _np(sd[tkey + ".weight"]).T)
        self._bias(sd, tkey, fpath)

    def ln(self, sd, tkey, *fpath):
        self._set([*fpath, "scale"], _np(sd[tkey + ".weight"]))
        self._set([*fpath, "bias"], _np(sd[tkey + ".bias"]))

    def snake(self, sd, tkey, *fpath):
        """Snake1d alpha (1, C, 1) -> (C,)."""
        self._set([*fpath, "alpha"], _np(sd[tkey + ".alpha"]).reshape(-1))

    def raw(self, sd, tkey, *fpath):
        self._set([*fpath], _np(sd[tkey]))

    def mha(self, sd, tprefix, *fpath):
        """nn.MultiheadAttention: ``in_proj_weight`` split into q/k/v Dense."""
        w = _np(sd[tprefix + ".in_proj_weight"])
        b = _np(sd[tprefix + ".in_proj_bias"])
        d = w.shape[0] // 3
        for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
            self._set([*fpath, name, "kernel"], w[i * d:(i + 1) * d].T)
            self._set([*fpath, name, "bias"], b[i * d:(i + 1) * d])
        self.dense(sd, tprefix + ".out_proj", *fpath, "o_proj")


def _residual_unit(cv: _Converter, sd, tprefix: str, *fpath):
    cv.snake(sd, f"{tprefix}.block.0", *fpath, "snake1")
    cv.conv(sd, f"{tprefix}.block.1", *fpath, "conv1")
    cv.snake(sd, f"{tprefix}.block.2", *fpath, "snake2")
    cv.conv(sd, f"{tprefix}.block.3", *fpath, "conv2")


def convert_torch_facodec(encoder_sd: Dict, decoder_sd: Dict, cfg: CodecConfig) -> Dict:
    """Map upstream ``ns3_codec`` encoder and decoder state dicts onto the
    FACodec tree (nested dict of numpy arrays, the JAX package's layout).
    A missing torch key raises ``KeyError``; the gradient-reversal heads and
    other training-only keys are left unread by design.  Coverage and
    shapes are checked where the tree is loaded
    (``bridge.facodec_from_params``)."""
    if cfg.spk_dim != cfg.latent_dim:
        raise ValueError("released FACodec timbre embeddings are latent_dim-sized; got "
                         f"spk_dim={cfg.spk_dim} != latent_dim={cfg.latent_dim}")
    cv = _Converter()
    n = len(cfg.up_ratios)

    # encoder: block.0 .. block.{n + 2}
    cv.conv(encoder_sd, "block.0", "encoder", "stem")
    for i in range(n):
        t, f = f"block.{i + 1}.block", f"block_{i}"
        for j in range(3):
            _residual_unit(cv, encoder_sd, f"{t}.{j}", "encoder", f, f"res_{j}")
        cv.snake(encoder_sd, f"{t}.3", "encoder", f, "snake")
        cv.conv(encoder_sd, f"{t}.4", "encoder", f, "down")
    cv.snake(encoder_sd, f"block.{n + 1}", "encoder", "snake_out")
    cv.conv(encoder_sd, f"block.{n + 2}", "encoder", "head")

    # quantizers: upstream ModuleList order [prosody, content, residual]
    for fname, b, num_q in (("vq_prosody", 0, cfg.vq_num_q_p), ("vq_content", 1, cfg.vq_num_q_c),
                            ("vq_residual", 2, cfg.vq_num_q_r)):
        for j in range(num_q):
            t = f"quantizer.{b}.quantizers.{j}"
            cv.conv1x1_as_dense(decoder_sd, f"{t}.in_proj", fname, f"vq_{j}", "in_proj")
            cv.conv1x1_as_dense(decoder_sd, f"{t}.out_proj", fname, f"vq_{j}", "out_proj")
            cv.raw(decoder_sd, f"{t}.codebook.weight", fname, f"vq_{j}", "codebook")

    # timbre transformer (timbre_norm has no parameters)
    for i in range(4):
        t, f = f"timbre_encoder.layers.{i}", ("timbre", f"layer_{i}")
        cv.ln(decoder_sd, f"{t}.ln_1", *f, "ln_1")
        cv.mha(decoder_sd, f"{t}.self_attn", *f)
        cv.ln(decoder_sd, f"{t}.ln_2", *f, "ln_2")
        cv.conv(decoder_sd, f"{t}.ffn.ffn_1", *f, "ffn", "ffn_1")
        cv.dense(decoder_sd, f"{t}.ffn.ffn_2", *f, "ffn", "ffn_2")
    cv.ln(decoder_sd, "timbre_encoder.last_ln", "timbre", "last_ln")
    cv.dense(decoder_sd, "timbre_linear", "decoder", "timbre_linear")

    # generator: model.0 .. model.{n + 2}
    cv.conv(decoder_sd, "model.0", "decoder", "stem")
    for i in range(n):
        t, f = f"model.{i + 1}.block", f"block_{i}"
        cv.snake(decoder_sd, f"{t}.0", "decoder", f, "snake")
        cv.conv_t(decoder_sd, f"{t}.1", "decoder", f, "up")
        for j in range(3):
            _residual_unit(cv, decoder_sd, f"{t}.{2 + j}", "decoder", f, f"res_{j}")
    cv.snake(decoder_sd, f"model.{n + 1}", "decoder", "snake_out")
    cv.conv(decoder_sd, f"model.{n + 2}", "decoder", "head")
    return cv.out


def load_torch_facodec(encoder_ckpt_path: str, decoder_ckpt_path: str, cfg: CodecConfig) -> Dict:
    """Read ``ns3_facodec_encoder.bin`` / ``ns3_facodec_decoder.bin`` from
    local paths and convert them (:func:`convert_torch_facodec`)."""
    for p in (encoder_ckpt_path, decoder_ckpt_path):
        if not os.path.exists(p):
            raise FileNotFoundError(f"FACodec checkpoint not found: {p}")
    enc_sd = torch.load(encoder_ckpt_path, map_location="cpu", weights_only=True)
    dec_sd = torch.load(decoder_ckpt_path, map_location="cpu", weights_only=True)
    return convert_torch_facodec(enc_sd, dec_sd, cfg)
