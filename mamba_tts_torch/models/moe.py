"""The granite decoder's mixture of experts (Hugging Face's
``GraniteMoeHybridMoE`` with its ``shared_mlp``), for one device of an
expert-parallel deployment.  The JAX package has no counterpart.

    logits = router(x)                      (n_experts, in f32)
    gates  = softmax over the top_k logits  (the other experts' gates 0)
    y = Σ_{held e} gate_e · W_out,e(SiLU(a_e) · b_e),  [a_e || b_e] = W_in,e x
      + W_out,s(SiLU(a_s) · b_s),  [a_s || b_s] = W_in,s x      (the shared MLP)

The router keeps all ``n_experts`` outputs and its ``top_k``; this device
holds experts [first, first + held) (``MoEConfig.held``) and adds their
share only.  What the experts held elsewhere would add is left out: no
gate is renormalised, no exchange stands in for the absent devices.  The
shared MLP runs on every token.

- :meth:`MoE.forward` — tokens (..., d): each held expert over the tokens
  routed to it (a gather, the two products, a weighted scatter-add), the
  prefill's and teacher forcing's form.
- :meth:`MoE.step` — the decode step's form, capturable in a CUDA graph: one
  batched product over the held experts' stacked weights for every row,
  weighted by each row's gates, zero for the experts not routed to: it reads
  each held expert once and computes every (row, held expert) pair.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_tts_torch.config import MoEConfig
from mamba_tts_torch.models.layers import Dense, count_product, normal_init


class SharedMLP(nn.Module):
    """``GraniteMoeHybridMLP``: output_linear(SiLU(a) · b), [a || b] =
    input_linear(x), no biases."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.bfloat16):
        super().__init__()
        self.input_linear = Dense(d_model, 2 * d_ff, bias=False, dtype=dtype)
        self.output_linear = Dense(d_ff, d_model, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.input_linear(x).chunk(2, dim=-1)
        return self.output_linear(F.silu(a) * b)


class MoE(nn.Module):
    """See the module's docstring.  ``router`` (n_experts, d) f32;
    ``input_linear`` (held, 2·d_expert, d) and ``output_linear`` (held, d,
    d_expert) in ``dtype``, the layout of ``GraniteMoeHybridParallelExperts``
    cut to the held experts; ``shared_mlp`` where ``d_shared``."""

    def __init__(self, d_model: int, cfg: MoEConfig, dtype=torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.lo, self.hi = cfg.held
        held, de = self.hi - self.lo, cfg.d_expert
        self.router = Dense(d_model, cfg.n_experts, bias=False, dtype=torch.float32)
        self.input_linear = nn.Parameter(torch.zeros((held, 2 * de, d_model), dtype=dtype))
        self.output_linear = nn.Parameter(torch.zeros((held, d_model, de), dtype=dtype))
        self.shared_mlp = SharedMLP(d_model, cfg.d_shared, dtype) if cfg.d_shared else None

    def init_weights(self, g: torch.Generator) -> None:
        """LeCun-normal experts: std 1/sqrt of each product's fan-in."""
        normal_init(self.input_linear, 1.0 / math.sqrt(self.input_linear.shape[2]), g)
        normal_init(self.output_linear, 1.0 / math.sqrt(self.output_linear.shape[2]), g)

    def gates(self, x: torch.Tensor) -> torch.Tensor:
        """(..., d) -> the held experts' gates (..., held) in f32: the
        softmax over each token's top_k router logits, 0 for the experts not
        among them; the gates of the experts held elsewhere are dropped."""
        logits = self.router(x.float())
        top, idx = logits.topk(self.cfg.top_k, dim=-1)
        full = torch.zeros_like(logits).scatter_(-1, idx, torch.softmax(top, dim=-1))
        return full[..., self.lo:self.hi]

    def _shared(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return y if self.shared_mlp is None else y + self.shared_mlp(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., d) -> (..., d) in the compute dtype: each held expert over
        the tokens routed to it."""
        shape = x.shape
        flat = x.reshape(-1, shape[-1]).to(self.dtype)
        g = self.gates(flat)
        out = torch.zeros(flat.shape, dtype=torch.float32, device=x.device)
        for e in range(self.hi - self.lo):
            rows = torch.nonzero(g[:, e] > 0)[:, 0]
            if rows.numel() == 0:
                continue
            a, b = F.linear(flat[rows], self.input_linear[e]).chunk(2, dim=-1)
            o = F.linear(F.silu(a) * b, self.output_linear[e])
            out.index_add_(0, rows, o.float() * g[rows, e, None])
        return self._shared(x, out.to(self.dtype).reshape(shape))

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """One token a row, x (B, 1, d) -> (B, 1, d): every held expert on
        every row in two batched products (each counted by
        ``layers.dense_products``), weighted by the rows' gates."""
        xt = x[:, 0].to(self.dtype)
        g = self.gates(xt)  # (B, held)
        count_product(self.input_linear, None, self.dtype)
        a, b = torch.matmul(xt, self.input_linear.transpose(1, 2)).chunk(2, dim=-1)
        count_product(self.output_linear, None, self.dtype)
        o = torch.matmul(F.silu(a) * b, self.output_linear.transpose(1, 2))  # (held, B, d)
        y = (o.float() * g.t()[..., None]).sum(dim=0)
        return self._shared(x, y.to(self.dtype)[:, None])
