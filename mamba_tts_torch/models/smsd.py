"""SMSD — style mixture density head — counterpart of
``mamba_tts_tpu/models/smsd.py`` (inference half).

A Gaussian mixture-density network over frozen style-text ([CLS])
embeddings.  All four variance modes:

  - "isotropic_across_clusters" (default): one scalar sigma per example
  - "isotropic": one sigma per mixture component
  - "diagonal":  per-component, per-dimension sigma
  - "fixed":     constant std ``fixed_std``

Sampling: k ~ Categorical(pi), y = mu_k + sigma_k * eps.  ``torch.Generator``
draws cannot reproduce ``jax.random``, so :func:`sample_mixture` also takes
``k`` and ``eps`` directly; the parity tests feed both packages the same
noise that way.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_tts_torch.config import SMSDConfig
from mamba_tts_torch.models.layers import Dense, LayerNorm


class NoiseNet(nn.Module):
    """Learnable noise perturbation on the variance head; the identity at
    inference.  Holds the ``noise_scale`` parameter of the trained tree."""

    def __init__(self, noise_scale_init: float = 0.1):
        super().__init__()
        self.init_value = noise_scale_init
        self.noise_scale = nn.Parameter(torch.tensor(noise_scale_init))

    def init_weights(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.noise_scale.fill_(self.init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


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

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        c = self.cfg
        B = x.shape[0]
        K, d = c.num_mixtures, c.style_dim
        h = self.ln(x.to(torch.float32))
        h = F.relu(self.fc2(F.relu(self.fc1(h))))
        pi = torch.softmax(self.pi_head(h), dim=-1)
        mu = self.mu_head(h).reshape(B, K, d)
        if c.variance_mode == "fixed":
            return pi, mu, torch.full((B,), c.fixed_std, dtype=torch.float32, device=x.device)
        sigma = F.softplus(self.noise_net(self.sigma_head(h)))
        if c.variance_mode == "isotropic_across_clusters":
            sigma = sigma[:, 0]
        elif c.variance_mode == "diagonal":
            sigma = sigma.reshape(B, K, d)
        return pi, mu, sigma


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

    def forward(self, x_bert: torch.Tensor):
        return self.mdn_head(x_bert)

    def sample(self, x_bert: torch.Tensor, generator: Optional[torch.Generator] = None,
               k: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None):
        pi, mu, sigma = self.mdn_head(x_bert)
        return sample_mixture(pi, mu, sigma, self.cfg.variance_mode, self.cfg.fixed_std,
                              generator=generator, k=k, eps=eps)
