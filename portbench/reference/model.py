"""Plain reference of the measured TTS model, in float32 PyTorch.

A frozen copy of the system's plain arithmetic, written for clarity and not
speed: no custom kernel, no cache, no captured graph, no quantized weights.
Parameter names equal the system's, so the benchmark hands one set of
weights to both.  What the system derives from the weights (weight plans,
projected memories, quantized tables) is worked out again here from the raw
weights and inputs.

Departures from the system, each exact in real arithmetic:
- every layer computes in float32 (the system computes the text encoder,
  the duration predictor and the decoder in bfloat16);
- the selective scan runs chunk by chunk (64 steps a chunk, every chunk at
  once, then a carry over the chunks) instead of one step at a time;
- attention is materialized in blocks of queries.

``Numerics.fake`` (the precision control) rounds the inputs and weights of
every bfloat16 layer's product to a lower precision before the product.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.reference.config import (
    CodecConfig,
    DecoderConfig,
    DurationPredictorConfig,
    SMSDConfig,
    StyleEncoderConfig,
    TextEncoderConfig,
    TTSConfig,
)

NEG_INF = -1e9
SCAN_CHUNK = 64
QUERY_BLOCK = 1024


@dataclass
class Numerics:
    """``fake``: None, or a function that rounds a tensor to a lower
    precision, applied to both operands of every product of the layers the
    configuration states in bfloat16 (the precision control)."""
    fake: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude at e4m3's largest, 448): the precision control's rounding."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def _straight(x: torch.Tensor, fake) -> torch.Tensor:
    """``fake(x)`` in value, the identity in the gradient."""
    return x + (fake(x) - x).detach()


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = True, num: Optional[Numerics] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None
        self.num = num

    def forward(self, x):
        w, x = self.weight, x.float()
        if self.num is not None and self.num.fake is not None:
            w, x = _straight(w, self.num.fake), _straight(x, self.num.fake)
        return F.linear(x, w, self.bias)


class Conv(nn.Module):
    """Conv1d over (B, C, T) with explicit (left, right) padding or "SAME"."""

    def __init__(self, d_in, d_out, kernel, stride=1, dilation=1, padding="SAME",
                 num: Optional[Numerics] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in, kernel))
        self.bias = nn.Parameter(torch.zeros(d_out))
        if padding == "SAME":
            total = (kernel - 1) * dilation
            padding = (total // 2, total - total // 2)
        self.pads, self.stride, self.dilation, self.num = tuple(padding), stride, dilation, num

    def forward(self, x):
        w, x = self.weight, x.float()
        if self.num is not None and self.num.fake is not None:
            w, x = _straight(w, self.num.fake), _straight(x, self.num.fake)
        return F.conv1d(F.pad(x, self.pads), w, self.bias, self.stride, 0, self.dilation)


class ConvTranspose(nn.Module):
    """Upsampling transposed conv: kernel 2s, padding ceil(s/2), output
    padding s % 2, so T -> T * s; weight (in, out, k)."""

    def __init__(self, d_in, d_out, stride):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_in, d_out, 2 * stride))
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.stride = stride

    def forward(self, x):
        s = self.stride
        return F.conv_transpose1d(x.float(), self.weight, self.bias, s, (s + 1) // 2, s % 2)


class Embed(nn.Module):
    def __init__(self, num: int, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num, d))

    def forward(self, ids):
        return self.weight[ids]


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6, affine: bool = True):
        super().__init__()
        self.d, self.eps = d, eps
        self.weight = nn.Parameter(torch.ones(d)) if affine else None
        self.bias = nn.Parameter(torch.zeros(d)) if affine else None

    def forward(self, x):
        return F.layer_norm(x.float(), (self.d,), self.weight, self.bias, self.eps)


def dropout(x, rate, deterministic, generator):
    """Keep with probability 1 - rate, scale by 1 / (1 - rate); the mask is
    one ``torch.rand`` of ``x``'s shape from ``generator``, the draw the
    system makes at the same place."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def mask_bias(mask):
    return torch.where(mask[:, None, None, :], 0.0, NEG_INF).float()


def attention(q, k, v, mask, scale, block: int = QUERY_BLOCK):
    """softmax(q k^T * scale + bias) v over (B, H, T, hd), in query blocks."""
    bias = None if mask is None else mask_bias(mask)
    outs = []
    for lo in range(0, q.shape[2], block):
        s = torch.matmul(q[:, :, lo:lo + block], k.transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias
        outs.append(torch.matmul(torch.softmax(s, dim=-1), v))
    return torch.cat(outs, dim=2)


# ------------------------------------------------------------ text encoder

def sinusoid_position_table(n_position: int, d_hid: int) -> np.ndarray:
    pos = np.arange(n_position)[:, None].astype(np.float64)
    i = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (i // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class _SelfAttention(nn.Module):
    def __init__(self, d_model, n_heads, d_k, d_v, rate, num):
        super().__init__()
        self.n_heads, self.d_k, self.d_v, self.rate = n_heads, d_k, d_v, rate
        self.w_q = Dense(d_model, n_heads * d_k, num=num)
        self.w_k = Dense(d_model, n_heads * d_k, num=num)
        self.w_v = Dense(d_model, n_heads * d_v, num=num)
        self.w_o = Dense(n_heads * d_v, d_model, num=num)
        self.LayerNorm_0 = LayerNorm(d_model)

    def forward(self, x, mask, deterministic=True, generator=None):
        B, T, _ = x.shape
        H, dk, dv = self.n_heads, self.d_k, self.d_v
        q = self.w_q(x).reshape(B, T, H, dk).transpose(1, 2)
        k = self.w_k(x).reshape(B, T, H, dk).transpose(1, 2)
        v = self.w_v(x).reshape(B, T, H, dv).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dk)
        if mask is not None:
            logits = logits + mask_bias(mask)
        probs = dropout(torch.softmax(logits, dim=-1), self.rate, deterministic, generator)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, H * dv)
        out = dropout(self.w_o(out), self.rate, deterministic, generator)
        return self.LayerNorm_0(out + x)


class FFTBlock(nn.Module):
    def __init__(self, c: TextEncoderConfig, num):
        super().__init__()
        self.rate = c.dropout
        self.attn = _SelfAttention(c.d_model, c.n_heads, c.d_k, c.d_v, c.dropout, num)
        self.conv1 = Conv(c.d_model, c.d_inner, c.conv_kernel[0], num=num)
        self.conv2 = Conv(c.d_inner, c.d_model, c.conv_kernel[1], num=num)
        self.LayerNorm_0 = LayerNorm(c.d_model)

    def forward(self, x, mask, deterministic=True, generator=None):
        x = self.attn(x, mask, deterministic, generator)
        if mask is not None:
            x = x * mask[..., None]
        h = F.relu(self.conv1(x.transpose(1, 2)))
        h = dropout(self.conv2(h).transpose(1, 2), self.rate, deterministic, generator)
        x = self.LayerNorm_0(h + x)
        if mask is not None:
            x = x * mask[..., None]
        return x


class TextEncoder(nn.Module):
    def __init__(self, c: TextEncoderConfig, num):
        super().__init__()
        self.cfg = c
        self.phoneme_emb = Embed(c.vocab_size, c.d_model)
        for i in range(c.n_layers):
            self.add_module(f"fft_{i}", FFTBlock(c, num))

    def forward(self, ids, mask=None, deterministic=True, generator=None):
        c = self.cfg
        emb = self.phoneme_emb(ids) * (ids != c.padding_idx)[..., None].float()
        pos = torch.from_numpy(sinusoid_position_table(ids.shape[1], c.d_model)).to(emb.device)
        x = emb + pos[None]
        for i in range(c.n_layers):
            x = getattr(self, f"fft_{i}")(x, mask, deterministic, generator)
        return x


class DurationPredictor(nn.Module):
    def __init__(self, c: DurationPredictorConfig, num):
        super().__init__()
        self.rate = c.dropout
        self.conv1 = Conv(c.d_model, c.filter_size, c.kernel_size, num=num)
        self.LayerNorm_0 = LayerNorm(c.filter_size)
        self.conv2 = Conv(c.filter_size, c.filter_size, c.kernel_size, num=num)
        self.LayerNorm_1 = LayerNorm(c.filter_size)
        self.linear = Dense(c.filter_size, 1)

    def forward(self, x, mask=None, deterministic=True, generator=None):
        h = F.relu(self.conv1(x.transpose(1, 2))).transpose(1, 2)
        h = dropout(self.LayerNorm_0(h), self.rate, deterministic, generator)
        h = F.relu(self.conv2(h.transpose(1, 2))).transpose(1, 2)
        h = dropout(self.LayerNorm_1(h), self.rate, deterministic, generator)
        log_dur = self.linear(h)[..., 0]
        return log_dur * mask.float() if mask is not None else log_dur


# ------------------------------------------------------------------- SMSD

class NoiseNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.noise_scale = nn.Parameter(torch.tensor(0.1))

    def forward(self, x, deterministic=True, generator=None):
        if deterministic:
            return x
        eps = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        return x + self.noise_scale * eps


class MDNHead(nn.Module):
    """Isotropic-across-clusters mixture density head (the configuration's
    variance mode): one sigma per example."""

    def __init__(self, c: SMSDConfig):
        super().__init__()
        if c.variance_mode != "isotropic_across_clusters":
            raise ValueError("the reference covers variance_mode isotropic_across_clusters")
        self.cfg = c
        self.ln = LayerNorm(c.bert_dim)
        self.fc1 = Dense(c.bert_dim, c.hidden_dim)
        self.fc2 = Dense(c.hidden_dim, c.hidden_dim)
        self.pi_head = Dense(c.hidden_dim, c.num_mixtures)
        self.mu_head = Dense(c.hidden_dim, c.num_mixtures * c.style_dim)
        self.sigma_head = Dense(c.hidden_dim, 1)
        self.noise_net = NoiseNet()

    def forward(self, x, deterministic=True, generator=None):
        c = self.cfg
        h = self.ln(x)
        h = dropout(F.relu(self.fc1(h)), c.dropout, deterministic, generator)
        h = dropout(F.relu(self.fc2(h)), c.dropout, deterministic, generator)
        pi = torch.softmax(self.pi_head(h), dim=-1)
        mu = self.mu_head(h).reshape(x.shape[0], c.num_mixtures, c.style_dim)
        sigma = F.softplus(self.noise_net(self.sigma_head(h), deterministic, generator))[:, 0]
        return pi, mu, sigma


class SMSD(nn.Module):
    def __init__(self, c: SMSDConfig):
        super().__init__()
        self.cfg = c
        self.mdn_head = MDNHead(c)

    def loss(self, x, y, deterministic=False, generator=None):
        pi, mu, sigma = self.mdn_head(x, deterministic, generator)
        d = mu.shape[-1]
        var = (sigma ** 2)[:, None]
        logp = (-0.5 * d * math.log(2.0 * math.pi) - 0.5 * d * torch.log(var)
                - 0.5 * ((y[:, None, :].float() - mu) ** 2).sum(-1) / var)
        return -torch.logsumexp(torch.log(pi + 1e-8) + logp, dim=1).mean()

    def sample(self, x, generator):
        """k ~ Categorical(pi), y = mu_k + sigma * eps: one ``multinomial``
        then one ``randn`` from ``generator``, as the system draws them."""
        pi, mu, sigma = self.mdn_head(x)
        B, K, d = mu.shape
        k = torch.multinomial(pi + 1e-8, 1, generator=generator)[:, 0]
        mu_sel = torch.gather(mu, 1, k[:, None, None].expand(B, 1, d))[:, 0]
        eps = torch.randn(mu_sel.shape, generator=generator, dtype=torch.float32,
                          device=mu.device)
        return mu_sel + eps * sigma[:, None]


# ------------------------------------------------------------------- BERT

_BERT_LN_EPS = 1e-12


class _BertLayer(nn.Module):
    def __init__(self, c: StyleEncoderConfig):
        super().__init__()
        self.cfg = c
        self.q, self.k, self.v = (Dense(c.d_model, c.d_model) for _ in range(3))
        self.attn_out = Dense(c.d_model, c.d_model)
        self.attn_ln = LayerNorm(c.d_model, eps=_BERT_LN_EPS)
        self.ffn_in = Dense(c.d_model, c.d_ff)
        self.ffn_out = Dense(c.d_ff, c.d_model)
        self.ffn_ln = LayerNorm(c.d_model, eps=_BERT_LN_EPS)

    def forward(self, x, mask):
        c = self.cfg
        B, T, _ = x.shape
        H, hd = c.n_heads, c.d_model // c.n_heads

        def heads(t):
            return t.reshape(B, T, H, hd).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        att = attention(q, k, v, mask, 1.0 / math.sqrt(hd))
        x = self.attn_ln(x + self.attn_out(att.transpose(1, 2).reshape(B, T, c.d_model)))
        return self.ffn_ln(x + self.ffn_out(F.gelu(self.ffn_in(x), approximate="none")))


class BertEncoder(nn.Module):
    """[CLS] hidden state of a post-LN BERT encoder."""

    def __init__(self, c: StyleEncoderConfig):
        super().__init__()
        self.cfg = c
        self.word_emb = Embed(c.vocab_size, c.d_model)
        self.pos_emb = Embed(c.max_position, c.d_model)
        self.type_emb = Embed(c.type_vocab_size, c.d_model)
        self.emb_ln = LayerNorm(c.d_model, eps=_BERT_LN_EPS)
        for i in range(c.n_layers):
            self.add_module(f"layer_{i}", _BertLayer(c))

    def forward(self, ids, mask):
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        x = self.emb_ln(self.word_emb(ids) + self.pos_emb(pos)
                        + self.type_emb(torch.zeros_like(ids)))
        for i in range(self.cfg.n_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return x[:, 0, :]


# ------------------------------------------------------------------ FACodec

class Snake(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(ch))

    def forward(self, x):
        a = self.alpha[None, :, None]
        return x + torch.sin(a * x) ** 2 / (a + 1e-9)


class ResidualUnit(nn.Module):
    def __init__(self, ch, dilation):
        super().__init__()
        p = 3 * dilation
        self.snake1 = Snake(ch)
        self.conv1 = Conv(ch, ch, 7, dilation=dilation, padding=(p, p))
        self.snake2 = Snake(ch)
        self.conv2 = Conv(ch, ch, 1, padding=(0, 0))

    def forward(self, x):
        return x + self.conv2(self.snake2(self.conv1(self.snake1(x))))


class EncoderBlock(nn.Module):
    def __init__(self, c_in, c_out, stride):
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
    def __init__(self, c: CodecConfig):
        super().__init__()
        self.cfg = c
        ch = c.ngf
        self.stem = Conv(1, ch, 7, padding=(3, 3))
        for i, r in enumerate(c.up_ratios):
            self.add_module(f"block_{i}", EncoderBlock(ch, 2 * ch, r))
            ch *= 2
        self.snake_out = Snake(ch)
        self.head = Conv(ch, c.latent_dim, 3, padding=(1, 1))

    def forward(self, wav):
        x = self.stem(wav[:, None, :])
        for i in range(len(self.cfg.up_ratios)):
            x = getattr(self, f"block_{i}")(x)
        return self.head(self.snake_out(x))


class DecoderBlock(nn.Module):
    def __init__(self, c_in, c_out, stride):
        super().__init__()
        self.snake = Snake(c_in)
        self.up = ConvTranspose(c_in, c_out, stride)
        for i, d in enumerate((1, 3, 9)):
            self.add_module(f"res_{i}", ResidualUnit(c_out, d))

    def forward(self, x):
        x = self.up(self.snake(x))
        for i in range(3):
            x = getattr(self, f"res_{i}")(x)
        return x


class CodecDecoder(nn.Module):
    """Latents (B, T_f, D) -> waveform, with no speaker FiLM (the served
    path decodes without a speaker embedding)."""

    def __init__(self, c: CodecConfig):
        super().__init__()
        self.cfg = c
        self.timbre_linear = Dense(c.spk_dim, 2 * c.latent_dim)  # unused without a speaker
        ch = c.decoder_initial_channels
        self.stem = Conv(c.latent_dim, ch, 7, padding=(3, 3))
        for i, r in enumerate(reversed(c.up_ratios)):
            self.add_module(f"block_{i}", DecoderBlock(ch, ch // 2, r))
            ch //= 2
        self.snake_out = Snake(ch)
        self.head = Conv(ch, 1, 7, padding=(3, 3))

    def forward(self, z):
        x = self.stem(z.transpose(1, 2))
        for i in range(len(self.cfg.up_ratios)):
            x = getattr(self, f"block_{i}")(x)
        return torch.tanh(self.head(self.snake_out(x)))[:, 0, :]


class VectorQuantizer(nn.Module):
    def __init__(self, size, dim, latent):
        super().__init__()
        self.in_proj = Dense(latent, dim)
        self.codebook = nn.Parameter(torch.zeros(size, dim))
        self.out_proj = Dense(dim, latent)

    def forward(self, z):
        down = self.in_proj(z)
        e = down / torch.clamp(down.norm(dim=-1, keepdim=True), min=1e-12)
        cb = self.codebook / torch.clamp(self.codebook.norm(dim=-1, keepdim=True), min=1e-12)
        ids = torch.argmax(torch.matmul(e, cb.T), dim=-1)
        return self.out_proj(self.codebook[ids]), ids

    def lookup(self, ids):
        return self.out_proj(self.codebook[ids])


class ResidualVQ(nn.Module):
    def __init__(self, num_q, size, dim, latent):
        super().__init__()
        self.num_q = num_q
        for i in range(num_q):
            self.add_module(f"vq_{i}", VectorQuantizer(size, dim, latent))

    def forward(self, z):
        residual, total, ids = z, torch.zeros_like(z), []
        for i in range(self.num_q):
            q, j = getattr(self, f"vq_{i}")(residual)
            residual, total = residual - q, total + q
            ids.append(j)
        return total, torch.stack(ids, dim=0)

    def lookup(self, ids):
        return sum(getattr(self, f"vq_{i}").lookup(ids[i]) for i in range(self.num_q))


class TimbreFFN(nn.Module):
    def __init__(self, hidden, filter_size, k=5):
        super().__init__()
        self.ffn_1 = Conv(hidden, filter_size, k, padding=(k // 2, k // 2))
        self.ffn_2 = Dense(filter_size, hidden)

    def forward(self, x):
        return self.ffn_2(F.relu(self.ffn_1(x.transpose(1, 2))).transpose(1, 2))


class TimbreEncoderLayer(nn.Module):
    def __init__(self, hidden, heads, filter_size):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        self.ln_1 = LayerNorm(hidden, eps=1e-5)
        self.q_proj, self.k_proj, self.v_proj, self.o_proj = (Dense(hidden, hidden)
                                                              for _ in range(4))
        self.ln_2 = LayerNorm(hidden, eps=1e-5)
        self.ffn = TimbreFFN(hidden, filter_size)

    def forward(self, x):
        B, T, _ = x.shape
        hd = self.hidden // self.heads
        h = self.ln_1(x)

        def heads(t):
            return t.reshape(B, T, self.heads, hd).transpose(1, 2)

        att = attention(heads(self.q_proj(h)), heads(self.k_proj(h)), heads(self.v_proj(h)),
                        None, 1.0 / math.sqrt(hd))
        x = x + self.o_proj(att.transpose(1, 2).reshape(B, T, self.hidden))
        return x + self.ffn(self.ln_2(x))


class TimbreExtractor(nn.Module):
    """Present so that the parameter tree matches; the served path discards
    the speaker embedding, so the reference never runs it."""

    def __init__(self, c: CodecConfig, n_layers=4, n_heads=4, filter_size=1024):
        super().__init__()
        for i in range(n_layers):
            self.add_module(f"layer_{i}", TimbreEncoderLayer(c.latent_dim, n_heads, filter_size))
        self.last_ln = LayerNorm(c.latent_dim, eps=1e-5)
        if c.spk_dim != c.latent_dim:
            self.out = Dense(c.latent_dim, c.spk_dim)


class FACodec(nn.Module):
    def __init__(self, c: CodecConfig):
        super().__init__()
        self.cfg = c
        self.encoder = CodecEncoder(c)
        self.timbre = TimbreExtractor(c)
        self.vq_prosody = ResidualVQ(c.vq_num_q_p, c.codebook_size, c.codebook_dim, c.latent_dim)
        self.vq_content = ResidualVQ(c.vq_num_q_c, c.codebook_size, c.codebook_dim, c.latent_dim)
        self.vq_residual = ResidualVQ(c.vq_num_q_r, c.codebook_size, c.codebook_dim, c.latent_dim)
        self.decoder = CodecDecoder(c)

    def encode_ids(self, wav):
        """(num_q, B, T_f) ids in stream order [prosody, residual x3, content]."""
        h = self.encoder(wav).transpose(1, 2)
        qp, idp = self.vq_prosody(h)
        qc, idc = self.vq_content(h - qp)
        _, idr = self.vq_residual(h - qp - qc)
        return torch.cat([idp, idr, idc], dim=0)

    def decode(self, ids):
        c = self.cfg
        p, r, ct = c.vq_num_q_p, c.vq_num_q_r, c.vq_num_q_c
        z = (self.vq_prosody.lookup(ids[:p]) + self.vq_residual.lookup(ids[p:p + r])
             + self.vq_content.lookup(ids[p + r:p + r + ct]))
        return self.decoder(z)


# -------------------------------------------------------------- the decoder

def chunked_scan(u, delta, A, Bm, Cm, D, chunk: int = SCAN_CHUNK):
    """y_t = <C_t, h_t> + D u_t with h_t = exp(delta_t A) h_{t-1} + delta_t u_t B_t,
    h_0 = 0, in f32.  u, delta (b, T, d); A (d, n); B, C (b, T, n).  Each
    chunk runs from a zero state (all chunks at once), the chunk start states
    follow by a carry over the chunks, and a second sweep adds each start
    state's contribution."""
    b, T, d = u.shape
    n = A.shape[1]
    pad = (-T) % chunk
    if pad:
        u, delta, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (u, delta, Bm, Cm))
    nc = (T + pad) // chunk
    u, dl = u.reshape(b, nc, chunk, d), delta.reshape(b, nc, chunk, d)
    Bc, Cc = Bm.reshape(b, nc, chunk, n), Cm.reshape(b, nc, chunk, n)
    At = A.T[None, None]  # (1, 1, n, d)
    h = u.new_zeros((b, nc, n, d))
    decay = u.new_ones((b, nc, n, d))
    ys = []
    for t in range(chunk):
        a = torch.exp(dl[:, :, t, None, :] * At)
        h = a * h + (dl[:, :, t] * u[:, :, t])[:, :, None, :] * Bc[:, :, t, :, None]
        decay = decay * a
        ys.append(torch.einsum("bcnd,bcn->bcd", h, Cc[:, :, t]))
    starts, s = [], u.new_zeros((b, n, d))
    for c in range(nc):
        starts.append(s)
        s = decay[:, c] * s + h[:, c]
    g = torch.stack(starts, dim=1)
    for t in range(chunk):
        g = torch.exp(dl[:, :, t, None, :] * At) * g
        ys[t] = ys[t] + torch.einsum("bcnd,bcn->bcd", g, Cc[:, :, t])
    y = torch.stack(ys, dim=2).reshape(b, nc * chunk, d)[:, :T]
    return y + u.reshape(b, nc * chunk, d)[:, :T] * D


class MambaBlock(nn.Module):
    def __init__(self, c, num):
        super().__init__()
        self.cfg = c
        di = c.d_inner
        self.in_proj = Dense(c.d_model, 2 * di, bias=c.use_bias, num=num)
        self.conv_w = nn.Parameter(torch.zeros(c.d_conv, di))
        self.conv_b = nn.Parameter(torch.zeros(di))
        self.x_proj = Dense(di, c.dt_rank_actual + 2 * c.d_state, bias=False, num=num)
        self.dt_proj = Dense(c.dt_rank_actual, di, num=num)
        self.A_log = nn.Parameter(torch.zeros(di, c.d_state))
        self.D = nn.Parameter(torch.ones(di))
        self.out_proj = Dense(di, c.d_model, bias=c.use_bias, num=num)

    def forward(self, x):
        c = self.cfg
        xin, z = self.in_proj(x).chunk(2, dim=-1)
        T = xin.shape[1]
        xp = F.pad(xin, (0, 0, c.d_conv - 1, 0))
        conv = sum(xp[:, i:i + T] * self.conv_w[i] for i in range(c.d_conv)) + self.conv_b
        xc = F.silu(conv)
        dt_raw, Bm, Cm = torch.split(self.x_proj(xc), [c.dt_rank_actual, c.d_state, c.d_state],
                                     dim=-1)
        dt = F.softplus(self.dt_proj(dt_raw))
        y = chunked_scan(xc, dt, -torch.exp(self.A_log), Bm, Cm, self.D)
        return self.out_proj(y * F.silu(z))


class CrossAttention(nn.Module):
    def __init__(self, d_model, n_heads, num):
        super().__init__()
        self.n_heads, self.hd = n_heads, d_model // n_heads
        self.q_proj, self.k_proj, self.v_proj, self.o_proj = (Dense(d_model, d_model, num=num)
                                                              for _ in range(4))

    def forward(self, x, memory, mask):
        B, T, dm = x.shape

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.n_heads, self.hd).transpose(1, 2)

        out = attention(split(self.q_proj(x)), split(self.k_proj(memory)),
                        split(self.v_proj(memory)), mask, self.hd ** -0.5)
        return self.o_proj(out.transpose(1, 2).reshape(B, T, dm))


class DecoderLayer(nn.Module):
    def __init__(self, c: DecoderConfig, num):
        super().__init__()
        self.norm_mamba = LayerNorm(c.d_model)
        self.mamba = MambaBlock(c.with_mamba_dims().mamba, num)
        self.norm_cross = LayerNorm(c.d_model)
        self.cross_attn = CrossAttention(c.d_model, c.n_heads, num)
        self.norm_ff = LayerNorm(c.d_model)
        self.style_mlp = Dense(c.d_style, 2 * c.d_model, num=num)
        self.ff1 = Dense(c.d_model, c.d_ff, num=num)
        self.ff2 = Dense(c.d_ff, c.d_model, num=num)

    def forward(self, x, memory, mask, z_style):
        x = x + self.mamba(self.norm_mamba(x))
        x = x + self.cross_attn(self.norm_cross(x), memory, mask)
        gamma, beta = torch.tanh(self.style_mlp(z_style)).chunk(2, dim=-1)
        h = gamma[:, None, :] * self.norm_ff(x) + beta[:, None, :]
        return x + self.ff2(F.gelu(self.ff1(h), approximate="none"))


class MambaTTSDecoder(nn.Module):
    def __init__(self, c: DecoderConfig, num):
        super().__init__()
        self.cfg = c
        self.token_embed = Embed(c.vocab_size_audio, c.d_model)
        self.pos_embed = Embed(c.max_len, c.d_model)
        self.quant_embed = Embed(c.num_quantizers, c.d_model)
        for i in range(c.n_layers):
            self.add_module(f"layer_{i}", DecoderLayer(c, num))
        self.norm_out = LayerNorm(c.d_model)
        self.head = Dense(c.d_model, c.vocab_size_audio)

    def embed_grid(self, tokens_3d):
        """(B, Q, S) ids -> (B, Q*S, d), quantizer-major."""
        B, Q, S = tokens_3d.shape
        dev = tokens_3d.device
        q = torch.arange(Q, device=dev).repeat_interleave(S)[None]
        p = torch.arange(S, device=dev).repeat(Q)[None]
        return (self.token_embed(tokens_3d.reshape(B, Q * S)) + self.pos_embed(p)
                + self.quant_embed(q))

    def forward(self, inputs_3d, memory, mask, z_style, checkpoint_layers: bool = False):
        """Teacher-forced logits (B, Q*S, V) over the flattened grid of
        ``inputs_3d`` (the shifted inputs, BOS first)."""
        x = self.embed_grid(inputs_3d)
        for i in range(self.cfg.n_layers):
            layer = getattr(self, f"layer_{i}")
            if checkpoint_layers and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(layer, x, memory, mask, z_style,
                                                      use_reentrant=False)
            else:
                x = layer(x, memory, mask, z_style)
        return self.head(self.norm_out(x))


class MambaTTS(nn.Module):
    """The trainable model without the NAR style branch, which no loss and
    no served request reads (its gradients are zero in the system)."""

    def __init__(self, cfg: TTSConfig, num: Optional[Numerics] = None):
        super().__init__()
        self.cfg = cfg
        self.num = num or Numerics()
        self.text_encoder = TextEncoder(cfg.text_encoder, self.num)
        self.dur_predictor = DurationPredictor(cfg.duration, self.num)
        self.smsd = SMSD(cfg.smsd)
        self.decoder = MambaTTSDecoder(cfg.decoder.with_mamba_dims(), self.num)

    def memory(self, text_hidden, text_mask, voice_codec):
        """[ref || text] memory and mask from (B, S, Q) shifted voice ids."""
        dc = self.cfg.decoder
        v3 = voice_codec.transpose(1, 2).long()
        ref = self.decoder.embed_grid(v3)
        ref_mask = v3.reshape(v3.shape[0], -1) != dc.pad_id
        return (torch.cat([ref, text_hidden], dim=1), torch.cat([ref_mask, text_mask], dim=1))

    def shifted(self, targets_3d):
        """(B, Q, S) targets -> inputs [BOS, y[:-1]] over the flattened grid."""
        B, Q, S = targets_3d.shape
        flat = targets_3d.reshape(B, Q * S)
        bos = torch.full((B, 1), self.cfg.decoder.bos_id, dtype=flat.dtype, device=flat.device)
        return torch.cat([bos, flat[:, :-1]], dim=1).reshape(B, Q, S)

    def compute_losses(self, batch: Dict[str, torch.Tensor], generator) -> Dict[str, torch.Tensor]:
        """The training losses with dropout and noise drawn from ``generator``
        in the order the system draws them."""
        c = self.cfg
        ids, mask = batch["phoneme_ids"], batch["text_mask"]
        text_hidden = self.text_encoder(ids, mask, False, generator)
        loss_smsd = self.smsd.loss(batch["style_bert"], batch["spk_embs"], False, generator)
        with torch.no_grad():
            z_style = self.smsd.sample(batch["style_bert"], generator)
        log_dur = self.dur_predictor(text_hidden, mask, False, generator)
        lengths = torch.clamp(mask.sum(dim=1), min=1)
        per_ph = torch.clamp(batch["target_frames"].to(lengths.dtype) // lengths, min=1)
        dur_target = per_ph[:, None] * mask.to(per_ph.dtype)
        m = mask.float()
        err = (log_dur - torch.log(dur_target.float() + 1e-8)) ** 2
        loss_dur = (err * m).sum() / m.sum()
        memory, mem_mask = self.memory(text_hidden, mask, batch["voice_codec"])
        targets_3d = batch["target_codec"].transpose(1, 2).long()
        logits = self.decoder(self.shifted(targets_3d), memory, mem_mask, z_style,
                              checkpoint_layers=True)
        targets = targets_3d.reshape(targets_3d.shape[0], -1)
        nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1, targets[..., None])[..., 0]
        valid = (targets != c.decoder.pad_id).float()
        loss_codec = (nll * valid).sum() / valid.sum()
        tr = c.train
        total = tr.w_codec * loss_codec + tr.w_dur * loss_dur + tr.w_smsd * loss_smsd
        return {"loss_total": total, "loss_codec": loss_codec, "loss_dur": loss_dur,
                "loss_smsd": loss_smsd}


def adam_steps(model: nn.Module, batches: List[Dict[str, torch.Tensor]], generators,
               lr: float, max_norm: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8):
    """Steps of global-norm clipping then Adam (bias-corrected moments,
    update -lr * mu_hat / (sqrt(nu_hat) + eps)) from the model's current
    weights, one batch each.  Returns (losses per step, the first step's
    clipped gradient by leaf, the weights before the first step by leaf)."""
    params = {n: p for n, p in model.named_parameters()}
    start = {n: p.detach().clone() for n, p in params.items()}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], None
    for count, (batch, gen) in enumerate(zip(batches, generators), start=1):
        for p in params.values():
            p.grad = None
        out = model.compute_losses(batch, gen)
        out["loss_total"].backward()
        losses.append({k: float(v.detach()) for k, v in out.items()})
        with torch.no_grad():
            g = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
            norm = torch.linalg.vector_norm(torch.stack([t.norm() for t in g.values()]))
            if norm >= max_norm:
                g = {n: t / norm * max_norm for n, t in g.items()}
            if first is None:
                first = {n: t.clone() for n, t in g.items()}
            for n, p in params.items():
                mu[n].mul_(b1).add_(g[n] * (1 - b1))
                nu[n].mul_(b2).add_(g[n] * g[n] * (1 - b2))
                mh, nh = mu[n] / (1 - b1 ** count), nu[n] / (1 - b2 ** count)
                p.add_(-lr * mh / (torch.sqrt(nh) + eps))
        for p in params.values():
            p.grad = None
    return losses, first, start
