"""SMSD — style mixture density head — counterpart of
``mamba_tts_tpu/models/smsd.py``.

A Gaussian mixture-density network over frozen style-text ([CLS])
embeddings.  All four variance modes:

  - "isotropic_across_clusters" (default): one scalar sigma per example
  - "isotropic": one sigma per mixture component
  - "diagonal":  per-component, per-dimension sigma
  - "fixed":     constant std ``fixed_std``

Training objective: the GMM negative log-likelihood (:func:`mixture_nll_loss`,
:meth:`SMSD.loss`), with dropout in the MDN and ``NoiseNet``'s noise on the
variance head when ``deterministic=False``.  :class:`SMSDPipeline` takes
style-prompt strings through the style-text encoder.  Sampling: k ~ Categorical(pi),
y = mu_k + sigma_k * eps.  ``torch.Generator`` draws cannot reproduce
``jax.random``, so :func:`sample_mixture` also takes ``k`` and ``eps``
directly; the parity tests feed both packages the same noise that way.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_tts_torch.config import SMSDConfig, StyleEncoderConfig
from mamba_tts_torch.device import resolve_device
from mamba_tts_torch.models.layers import Dense, LayerNorm, dropout, seed_init
from mamba_tts_torch.models.style_text_encoder import StyleTextEncoder
from mamba_tts_torch.parallel.comm import global_mean


class NoiseNet(nn.Module):
    """Learnable noise perturbation on the variance head: ``x + noise_scale *
    eps`` in training, the identity at inference."""

    def __init__(self, noise_scale_init: float = 0.1):
        super().__init__()
        self.init_value = noise_scale_init
        self.noise_scale = nn.Parameter(torch.tensor(noise_scale_init))

    def init_weights(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.noise_scale.fill_(self.init_value)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if deterministic:
            return x
        if generator is None:
            raise ValueError("NoiseNet in training needs a torch.Generator")
        eps = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        return x + self.noise_scale * eps


_SIGMA_WIDTH = {
    "isotropic_across_clusters": lambda K, d: 1,
    "isotropic": lambda K, d: K,
    "diagonal": lambda K, d: K * d,
}


class MDNHead(nn.Module):
    """(B, bert_dim) embedding -> GMM parameters (pi, mu, sigma)."""

    def __init__(self, cfg: SMSDConfig):
        super().__init__()
        c = self.cfg = cfg
        K, d = c.num_mixtures, c.style_dim
        if c.variance_mode not in _SIGMA_WIDTH and c.variance_mode != "fixed":
            raise ValueError(f"unknown variance_mode: {c.variance_mode}")
        self.ln = LayerNorm(c.bert_dim)
        self.fc1 = Dense(c.bert_dim, c.hidden_dim)
        self.fc2 = Dense(c.hidden_dim, c.hidden_dim)
        self.pi_head = Dense(c.hidden_dim, K)
        self.mu_head = Dense(c.hidden_dim, K * d)
        if c.variance_mode != "fixed":
            self.sigma_head = Dense(c.hidden_dim, _SIGMA_WIDTH[c.variance_mode](K, d))
            self.noise_net = NoiseNet(c.noise_scale)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        c = self.cfg
        B = x.shape[0]
        K, d = c.num_mixtures, c.style_dim
        h = self.ln(x.to(torch.float32))
        h = dropout(F.relu(self.fc1(h)), c.dropout, deterministic, generator)
        h = dropout(F.relu(self.fc2(h)), c.dropout, deterministic, generator)
        pi = torch.softmax(self.pi_head(h), dim=-1)
        mu = self.mu_head(h).reshape(B, K, d)
        if c.variance_mode == "fixed":
            return pi, mu, torch.full((B,), c.fixed_std, dtype=torch.float32, device=x.device)
        sigma = F.softplus(self.noise_net(self.sigma_head(h), deterministic, generator))
        if c.variance_mode == "isotropic_across_clusters":
            sigma = sigma[:, 0]
        elif c.variance_mode == "diagonal":
            sigma = sigma.reshape(B, K, d)
        return pi, mu, sigma


def mixture_nll_loss(y_true: torch.Tensor, pi: torch.Tensor, mu: torch.Tensor,
                     sigma: torch.Tensor, variance_mode: str = "isotropic_across_clusters",
                     fixed_variance: float = 0.01, group=None) -> torch.Tensor:
    """Negative log-likelihood of a Gaussian mixture, mean over the batch
    (the global batch of the data-parallel ``group``).

    y_true (B, d); pi (B, K); mu (B, K, d); sigma (B,) | (B, K) | (B, K, d)
    by mode; "fixed" uses the variance ``fixed_variance``."""
    y_true, mu = y_true.to(torch.float32), mu.to(torch.float32)
    B, K, d = mu.shape
    diff2 = (y_true[:, None, :] - mu) ** 2  # (B, K, d)
    log2pi = math.log(2.0 * math.pi)
    if variance_mode == "isotropic_across_clusters":
        var = (sigma.to(torch.float32) ** 2)[:, None]
        logp = -0.5 * d * log2pi - 0.5 * d * torch.log(var) - 0.5 * diff2.sum(-1) / var
    elif variance_mode == "isotropic":
        var = sigma.to(torch.float32) ** 2
        logp = -0.5 * d * log2pi - 0.5 * d * torch.log(var) - 0.5 * diff2.sum(-1) / var
    elif variance_mode == "diagonal":
        var = sigma.to(torch.float32) ** 2
        logp = -0.5 * d * log2pi - 0.5 * torch.log(var).sum(-1) - 0.5 * (diff2 / var).sum(-1)
    elif variance_mode == "fixed":
        var = fixed_variance
        logp = -0.5 * d * log2pi - 0.5 * d * math.log(var) - 0.5 * diff2.sum(-1) / var
    else:
        raise ValueError(f"unknown variance_mode: {variance_mode}")
    log_weighted = torch.log(pi + 1e-8) + logp  # (B, K)
    nll = -torch.logsumexp(log_weighted, dim=1)
    return global_mean(nll.sum(), torch.tensor(float(B), device=nll.device), group)


def sample_mixture(
    pi: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    variance_mode: str = "isotropic_across_clusters",
    fixed_std: float = 0.1,
    generator: Optional[torch.Generator] = None,
    k: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y ~ sum_k pi_k N(mu_k, sigma_k^2), (B, d).  ``k`` (B,) and ``eps``
    (B, d) are drawn from ``generator`` unless given."""
    B, K, d = mu.shape
    if k is None:
        k = torch.multinomial(pi.to(torch.float32) + 1e-8, 1, generator=generator)[:, 0]
    k = k.to(mu.device).long()
    mu_sel = torch.gather(mu, 1, k[:, None, None].expand(B, 1, d))[:, 0]
    if eps is None:
        eps = torch.randn(mu_sel.shape, generator=generator, dtype=torch.float32,
                          device=mu.device)
    if variance_mode == "isotropic_across_clusters":
        std = sigma[:, None]
    elif variance_mode == "isotropic":
        std = torch.gather(sigma, 1, k[:, None])
    elif variance_mode == "diagonal":
        std = torch.gather(sigma, 1, k[:, None, None].expand(B, 1, d))[:, 0]
    elif variance_mode == "fixed":
        std = fixed_std
    else:
        raise ValueError(f"unknown variance_mode: {variance_mode}")
    return mu_sel + eps * std


class SMSD(nn.Module):
    """MDN head over precomputed style-text embeddings."""

    def __init__(self, cfg: SMSDConfig):
        super().__init__()
        self.cfg = cfg
        self.mdn_head = MDNHead(cfg)

    def forward(self, x_bert: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        return self.mdn_head(x_bert, deterministic, generator)

    def loss(self, x_bert: torch.Tensor, y_true: torch.Tensor, deterministic: bool = False,
             generator: Optional[torch.Generator] = None, group=None) -> torch.Tensor:
        pi, mu, sigma = self.mdn_head(x_bert, deterministic, generator)
        return mixture_nll_loss(y_true, pi, mu, sigma, self.cfg.variance_mode,
                                self.cfg.fixed_variance, group)

    def sample(self, x_bert: torch.Tensor, generator: Optional[torch.Generator] = None,
               k: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None):
        pi, mu, sigma = self.mdn_head(x_bert)
        return sample_mixture(pi, mu, sigma, self.cfg.variance_mode, self.cfg.fixed_std,
                              generator=generator, k=k, eps=eps)


class SMSDPipeline:
    """Host-side wrapper with the reference's call signature
    (``mamba_tts_tpu/models/smsd.py:209``): style-prompt strings in, the loss
    (``y_true`` given) or sampled style vectors out, with ``(pi, mu, sigma)``
    when ``return_params``.  Composes the port's style-text encoder (BERT)
    with the MDN head; training uses the pieces directly.  The sample draws
    from ``generator``, or takes ``k`` (B,) and ``eps`` (B, d) as given."""

    def __init__(self, cfg: SMSDConfig, style_encoder=None, module: Optional[SMSD] = None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        dev = resolve_device(device)
        if style_encoder is not None:
            self.encoder = style_encoder
        elif cfg.bert_dim == 768:
            self.encoder = StyleTextEncoder(StyleEncoderConfig(), device=dev)
        else:
            heads = next(h for h in (12, 8, 4, 2, 1) if cfg.bert_dim % h == 0)
            self.encoder = StyleTextEncoder(StyleEncoderConfig(
                d_model=cfg.bert_dim, n_layers=2, n_heads=heads, d_ff=4 * cfg.bert_dim),
                device=dev)
        self.module = (module if module is not None else seed_init(SMSD(cfg), seed)).to(dev).eval()

    @torch.no_grad()
    def __call__(self, style_texts, y_true=None, return_params: bool = False,
                 generator: Optional[torch.Generator] = None, k: Optional[torch.Tensor] = None,
                 eps: Optional[torch.Tensor] = None):
        if isinstance(style_texts, str):
            style_texts = [style_texts]
        x = self.encoder.embed(list(style_texts))
        if y_true is not None:
            return self.module.loss(x, torch.as_tensor(y_true, device=x.device),
                                    deterministic=True)
        y = self.module.sample(x, generator, k=k, eps=eps)
        if return_params:
            return y, self.module(x)
        return y
