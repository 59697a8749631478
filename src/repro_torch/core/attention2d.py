"""2D-Attention entry points (counterpart of
``src/repro/core/attention2d.py``).

This slice covers one head rank and one context rank (``hp == cp == 1``),
where 2D-Attention is one ``flash_attention`` call.  The SeqAlltoAll over
``head`` and the zigzag double ring over ``outer x inner`` come with ROADMAP
queue 1, item 6.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.core.topology import AXIS_HP, AXIS_INNER, AXIS_OUTER
from repro_torch.kernels.ops import flash_attention


class Attn2DConfig(NamedTuple):
    """Static 2D-Attention configuration."""
    hp: int = 1
    n_out: int = 1            # outer ring size (d_cp / w)
    w: int = 1                # inner ring size (paper's w)
    causal: bool = True
    zigzag: bool = True       # False: contiguous chunks
    window: int | None = None
    softcap: float = 0.0
    scale: float | None = None
    impl: str = "auto"
    axis_hp: str = AXIS_HP
    axis_outer: str = AXIS_OUTER
    axis_inner: str = AXIS_INNER

    @property
    def cp(self) -> int:
        return self.n_out * self.w


def attn2d_config(pc, *, impl: str, causal: bool = True,
                  zigzag: bool = True, window: int | None = None,
                  softcap: float = 0.0,
                  scale: float | None = None) -> Attn2DConfig:
    """The one place a ``ParallelConfig`` becomes an ``Attn2DConfig``."""
    return Attn2DConfig(hp=pc.hp, n_out=pc.cp_outer, w=pc.cp_inner,
                        causal=causal, zigzag=zigzag, window=window,
                        softcap=softcap, scale=scale, impl=impl)


def attention_2d_local(q, k, v, cfg: Attn2DConfig, doc_start=None):
    """Per-rank 2D-Attention.  q ``(b, S, Hq, d)``; k/v ``(b, S, Hkv, d)``.
    Returns q-shaped out."""
    if cfg.hp > 1 or cfg.cp > 1:
        raise NotImplementedError(
            f"2D-Attention with hp={cfg.hp}, cp={cfg.cp}: the head all-to-all "
            "and the double ring are ROADMAP queue 1, item 6")
    if doc_start is not None and not cfg.causal:
        raise ValueError("packed documents require causal attention")
    dh = q.shape[-1]
    scale = cfg.scale if cfg.scale is not None else 1.0 / (dh ** 0.5)
    return flash_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                           softcap=cfg.softcap, scale=scale,
                           q_doc_start=doc_start, impl=cfg.impl)


def attention_2d(q, k, v, *, cfg: Attn2DConfig, doc_start=None):
    """Global-tensor 2D-Attention: q ``(B, S, Hq, d)``, k/v
    ``(B, S, Hkv, d)``; ``doc_start`` an optional ``(B, S)`` int32
    per-token document-start table."""
    return attention_2d_local(q, k, v, cfg, doc_start=doc_start)
