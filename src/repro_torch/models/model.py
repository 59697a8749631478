"""Model config, parameter init and shared entry helpers for the dense
family (counterpart of ``src/repro/models/model.py``).

Parameters are a plain dict: ``embed``, ``final_norm`` and ``layers``, a
list with one dict per layer (the JAX package stacks layers over a leading
group axis per period slot; ``convert.py`` unstacks them).  The training
forward (``backbone``, ``chunked_xent``, ``forward_loss``) and its fields
(``final_softcap``, ``remat``, ``zigzag``, ``loss_chunk``) come with the
training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.attention_block import AttnKind, init_gqa
from repro_torch.models.layers import (embedding_apply, init_embedding,
                                       init_glu_mlp, init_linear,
                                       init_rmsnorm, layernorm_nonparametric,
                                       rmsnorm_apply, rotary_cos_sin)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense (the only family ported so far)
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // n_heads
    # attention flavour
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    rope_theta_local: float = 10000.0
    attn_softcap: float = 0.0
    window: int | None = None
    window_pattern: int = 0      # period p: layer i is global iff i%p==p-1
    attn_bias: bool = False
    post_norms: bool = False
    # norms / mlp
    norm: str = "rms"            # rms | ln_np
    act: str = "silu"
    # embeddings
    embed_scale: bool = False    # x *= sqrt(d_model)
    tie_embeddings: bool = True
    # execution
    dtype: str = "bfloat16"
    init_std: float = 0.02

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def attn_kind(self, layer_in_period: int) -> AttnKind:
        """Attention kind for position ``layer_in_period`` of the pattern."""
        if self.window is not None and self.window_pattern:
            is_global = layer_in_period % self.window_pattern == \
                self.window_pattern - 1
        else:
            is_global = True
        return AttnKind(
            causal=True,
            window=None if is_global else self.window,
            softcap=self.attn_softcap,
            rope=self.rope,
            rope_theta=self.rope_theta if is_global
            else self.rope_theta_local)

    @property
    def period(self) -> int:
        return self.window_pattern or 1


def _require_dense(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: the port covers the dense family so far "
            "(ROADMAP queue 1, item 9)")


# ---------------------------------------------------------------------------
# Norm helpers
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, dim: int, *, device=None):
    if cfg.norm == "rms":
        return init_rmsnorm(dim, device=device)
    if cfg.norm == "ln_np":
        return {}
    raise NotImplementedError(f"norm {cfg.norm!r} (ROADMAP queue 1, item 9)")


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "rms":
        return rmsnorm_apply(p, x)
    if cfg.norm == "ln_np":
        return layernorm_nonparametric(x)
    raise NotImplementedError(f"norm {cfg.norm!r} (ROADMAP queue 1, item 9)")


# ---------------------------------------------------------------------------
# Rope table
# ---------------------------------------------------------------------------

def build_ropes(cfg: ModelConfig, positions):
    """{theta: (cos, sin)} for every theta the layer pattern uses."""
    thetas = {cfg.rope_theta}
    if cfg.window is not None and cfg.window_pattern:
        thetas.add(cfg.rope_theta_local)
    return {th: rotary_cos_sin(positions, cfg.hd, theta=th,
                               dtype=cfg.compute_dtype)
            for th in sorted(thetas)}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_transformer_block(gen: torch.Generator, cfg: ModelConfig, *,
                           device=None):
    p = {"ln1": init_norm(cfg, cfg.d_model, device=device),
         "ln2": init_norm(cfg, cfg.d_model, device=device),
         "attn": init_gqa(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.hd, qk_norm=cfg.qk_norm, bias=cfg.attn_bias,
                          device=device),
         "mlp": init_glu_mlp(gen, cfg.d_model, cfg.d_ff, device=device)}
    if cfg.post_norms:
        p["pn1"] = init_norm(cfg, cfg.d_model, device=device)
        p["pn2"] = init_norm(cfg, cfg.d_model, device=device)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device=None) -> dict:
    """fp32 parameters of the dense family, drawn from ``gen`` with the
    JAX package's distributions: linear weights N(0, d_in^-0.5), the
    embedding N(0, init_std), norm weights zero.  ``gen`` must live on
    ``device`` (default: the generator's own device)."""
    _require_dense(cfg)
    device = gen.device if device is None else torch.device(device)
    params: dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model,
                                std=cfg.init_std, device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab,
                                        std=cfg.init_std, device=device)
    params["final_norm"] = init_norm(cfg, cfg.d_model, device=device)
    if cfg.num_layers % cfg.period:
        raise ValueError(f"{cfg.num_layers} layers do not fill periods of "
                         f"{cfg.period}")
    params["layers"] = [init_transformer_block(gen, cfg, device=device)
                        for _ in range(cfg.num_layers)]
    return params


def cast_params_once(params, cfg: ModelConfig):
    """Matrices go to the compute dtype, 1-D leaves stay fp32.  Leaves
    already in that dtype are returned as they are, so a tree cast once
    before a loop is not copied again by every call."""
    dt = cfg.compute_dtype

    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        if isinstance(x, list):
            return [cast(v) for v in x]
        if x.ndim < 2 or not x.is_floating_point():
            return x
        return x.to(dt)

    return cast(params)


def lm_head_weight(params, cfg: ModelConfig):
    """``(vocab, d_model)``: the LM head in the ``(d_out, d_in)`` layout."""
    if cfg.tie_embeddings:
        return params["embed"]["table"]
    return params["lm_head"]["w"]


def embed_tokens(params, tokens, cfg: ModelConfig):
    scale = cfg.d_model ** 0.5 if cfg.embed_scale else None
    return embedding_apply(params["embed"], tokens,
                           dtype=cfg.compute_dtype, scale=scale)
