"""Layer functions: norms, linear, embedding, rotary, MLP (counterpart of
``src/repro/models/layers.py``).

Plain functions on tensors and parameter dicts.  Linear weights are
``(d_out, d_in)``, PyTorch's layout; ``convert.py`` transposes the JAX
package's ``(d_in, d_out)``.  Parameters are stored fp32 and cast to the
activation dtype at the call site.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def init_rmsnorm(dim: int, *, device=None):
    return {"w": torch.zeros((dim,), dtype=torch.float32, device=device)}


def rmsnorm_apply(p, x, *, eps: float = 1e-6):
    """RMSNorm in fp32 with ``(1 + w)`` scaling (zero-init w == identity)."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + p["w"].float())).to(dt)


def layernorm_nonparametric(x, *, eps: float = 1e-5):
    """OLMo-style non-parametric LayerNorm (no scale or bias)."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(dt)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, std: float | None = None, device=None):
    """``w (d_out, d_in)`` drawn from N(0, std), std = d_in ** -0.5 by
    default."""
    std = std if std is not None else d_in ** -0.5
    p = {"w": std * torch.randn((d_out, d_in), generator=gen,
                                dtype=torch.float32, device=device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


def linear_apply(p, x):
    """``x @ w.T`` with the weight cast to the activation dtype, so a bf16
    activation gives a bf16 product."""
    w = p["w"].to(x.dtype)
    b = p["b"].to(x.dtype) if "b" in p else None
    return F.linear(x, w, b)


def init_embedding(gen: torch.Generator, vocab: int, dim: int, *,
                   std: float = 0.02, device=None):
    return {"table": std * torch.randn((vocab, dim), generator=gen,
                                       dtype=torch.float32, device=device)}


def embedding_apply(p, ids, *, dtype, scale: float | None = None):
    out = p["table"][ids].to(dtype)
    if scale is not None:
        out = out * torch.tensor(scale, dtype=dtype, device=out.device)
    return out


def rotary_cos_sin(positions, head_dim: int, *, theta: float = 10000.0,
                   dtype=torch.float32):
    """positions ``(..., S)`` int -> cos/sin ``(..., S, head_dim/2)``.

    The frequencies are computed in numpy float64 and multiplied as fp32
    against the positions, then cos and sin are cast to ``dtype``, as in
    the JAX package."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half) * 2.0 / head_dim))
    freqs = torch.tensor(freqs, dtype=torch.float32, device=positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rotary(x, cos, sin):
    """x ``(B, S, H, D)``; cos/sin ``(B, S, D/2)``; pairs-as-halves."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def init_glu_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
                 device=None):
    """SwiGLU / GeGLU: W2(act(W1 x) * W3 x)."""
    return {"w1": init_linear(gen, d_model, d_ff, device=device),
            "w3": init_linear(gen, d_model, d_ff, device=device),
            "w2": init_linear(gen, d_ff, d_model, device=device)}


def glu_mlp_apply(p, x, *, act: str = "silu"):
    h = linear_apply(p["w1"], x)
    if act == "silu":
        h = F.silu(h)
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(act)
    return linear_apply(p["w2"], h * linear_apply(p["w3"], x))


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap else x
