"""Model config, parameter init and the training forward of the dense,
MoE, SSM, hybrid and encoder-decoder families (counterpart of
``src/repro/models/model.py``).

Parameters are a plain dict: ``embed``, ``final_norm`` and ``layers``, a
list with one dict per layer (the JAX package stacks layers over a leading
group axis per period slot and scans them; ``convert.py`` unstacks them and
``backbone`` loops over them).  The hybrid family (zamba2) adds
``shared_attn``, one transformer block that runs after every
``attn_every``-th Mamba2 layer of the whole groups (the reference's
``blocks``, ``(G, attn_every)``), and not after the tail layers
(``blocks_tail``); its grad is the sum over its uses.

Remat (``cfg.remat``) wraps each block in ``torch.utils.checkpoint``:

* ``none``: every activation is kept.
* ``full``: the block keeps only its input and recomputes everything in the
  backward, the attention forward kernel included.
* ``scpp`` (Selective Checkpoint++): the block is checkpointed in two
  halves around the attention call, so what the attention kernels saved
  (their folded q, k, v, ``attn_out`` and its lse) survives and the rest of
  the block is recomputed.  The forward kernel runs once a layer; the
  reference saves ``attn_out`` alone and re-runs it.

``chunked_xent`` recomputes each token chunk's logits in its backward,
so the tokens x vocab logits never exist at once.

The MoE family (qwen3-moe) swaps each layer's MLP for ``moe_apply``
(``models/moe.py``); its aux loss is summed over the layers and added to
the loss.  With ``cfg.mla`` (deepseek-v2-lite) a layer's attention is MLA
(``attention_block.mla_apply``) and the rope table is built at
``d_rope``; under ``scpp`` its split is GQA's, around ``mla_attend``.
The SSM family (falcon-mamba) stacks Mamba1 blocks and the
hybrid family Mamba2 blocks (``models/ssm.py``): pre-norm ``ln``, the
mixer, the residual.  Under ``full`` and ``scpp`` a Mamba block is
recomputed whole (it has no ``attn_out``); the shared attention block
keeps its ``attn_out`` under ``scpp`` like any other.

The encoder-decoder family (whisper) keeps ``enc_layers`` and
``dec_layers`` (the reference's stacked ``enc_blocks`` / ``dec_blocks``),
``enc_norm`` and the learned decoder positions ``dec_pos``.  The encoder
adds sinusoid positions to the given frames (the conv frontend is a stub,
as in the reference) and runs non-causal 2D-Attention on the contiguous
layout; the decoder runs causal self-attention on the zigzag layout, then
cross-attention over the whole encoder output
(``attention_block.cross_attn_apply``), then a GELU MLP.  Under ``scpp`` a
decoder layer is checkpointed in three pieces around its two attention
calls, so both outputs are kept (the reference saves both as
``attn_out``).

Packed documents (``batch["doc_start"]``, ``data/pipeline.py::PackedLM``)
reach only the attention: the doc-start table goes down to ``gqa_attend``
and masks each document to itself.

Under hybrid ZeRO on a mesh, ``forward_loss`` takes a ``gather``
(``core/zero.py::GatherAtUse``): the parameters are then this rank's
compute-dtype shards, and each layer gathers its leaves where it uses
them, inside the checkpointed functions, so the recompute gathers again
(each piece of a checkpointed layer gathers only the leaves it reads, so
no leaf is gathered twice a forward).
Without remat, the gathered weights stay out of the saved set
(``gather.out_of_saved()``).  The hybrid family's shared block is
gathered once a forward, before its first use, and kept for all of them
(the recompute of remat uses that copy), so its summed grad is reduced
once, as the tied table's is; so are whisper's ``dec_pos`` and
``enc_norm``.  One device passes no ``gather`` and uses
the parameters as they are.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.checkpoint import checkpoint

from repro_torch.core.runtime import all_reduce_, sum_over_world
from repro_torch.core.topology import seq_slice
from repro_torch.models.attention_block import (AttnKind, MLADims,
                                                _project_qkv, cross_attend,
                                                cross_attn_apply, gqa_apply,
                                                gqa_attend, init_cross_attn,
                                                init_gqa, init_mla, mla_attend,
                                                mla_project, project_cross)
from repro_torch.models.layers import (embedding_apply, gelu_mlp_apply,
                                       glu_mlp_apply, init_embedding,
                                       init_gelu_mlp, init_glu_mlp,
                                       init_layernorm, init_linear,
                                       init_rmsnorm, layernorm_apply,
                                       layernorm_nonparametric, linear_apply,
                                       rmsnorm_apply, rotary_cos_sin,
                                       sinusoid_positions)
from repro_torch.models.moe import MoEDims, init_moe, moe_apply
from repro_torch.models.ssm import (Mamba1Dims, Mamba2Dims, init_mamba1,
                                    init_mamba2, mamba1_apply, mamba2_apply)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec
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
    final_softcap: float = 0.0
    window: int | None = None
    window_pattern: int = 0      # period p: layer i is global iff i%p==p-1
    attn_bias: bool = False
    post_norms: bool = False
    # norms / mlp
    norm: str = "rms"            # rms | ln | ln_np
    act: str = "silu"
    # embeddings
    embed_scale: bool = False    # x *= sqrt(d_model)
    tie_embeddings: bool = True
    # family extras
    moe: MoEDims | None = None
    mla: MLADims | None = None
    ssm1: Mamba1Dims | None = None
    ssm2: Mamba2Dims | None = None
    attn_every: int = 0          # hybrid: shared attn block period
    encoder_layers: int = 0
    enc_frames: int = 1536       # stub conv-frontend output length (padded)
    max_positions: int = 4096    # whisper learned decoder positions
    # execution
    dtype: str = "bfloat16"
    remat: str = "scpp"          # none | full | scpp
    zigzag: bool = True
    loss_chunk: int = 512
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
        if self.family in ("dense", "moe"):
            return self.window_pattern or 1
        return 1


REMAT = ("none", "full", "scpp")


def remat_policy(name: str) -> str:
    """The checkpointing mode of a remat name (``none``, ``full`` or
    ``scpp``); anything else raises, as in the reference."""
    if name not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {name!r}")
    return name


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")


def require_ported(cfg: ModelConfig):
    """Raise unless the port runs ``cfg``: every family of the reference,
    with GQA or MLA attention."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}: one of "
                         f"{', '.join(FAMILIES)}")


def hybrid_groups(cfg: ModelConfig) -> tuple[int, int]:
    """``(G, tail)``: the hybrid trunk's whole groups of ``attn_every``
    Mamba2 layers, each followed by the shared block, and the layers
    after them."""
    if cfg.attn_every < 1 or cfg.num_layers < cfg.attn_every:
        raise ValueError(f"{cfg.num_layers} layers hold no group of "
                         f"attn_every = {cfg.attn_every}")
    return divmod(cfg.num_layers, cfg.attn_every)


# ---------------------------------------------------------------------------
# Norm helpers
# ---------------------------------------------------------------------------

NORMS = ("rms", "ln", "ln_np")


def init_norm(cfg: ModelConfig, dim: int, *, device=None):
    if cfg.norm == "rms":
        return init_rmsnorm(dim, device=device)
    if cfg.norm == "ln":
        return init_layernorm(dim, device=device)
    if cfg.norm == "ln_np":
        return {}
    raise ValueError(f"norm must be one of {NORMS}, got {cfg.norm!r}")


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "rms":
        return rmsnorm_apply(p, x)
    if cfg.norm == "ln":
        return layernorm_apply(p, x)
    if cfg.norm == "ln_np":
        return layernorm_nonparametric(x)
    raise ValueError(f"norm must be one of {NORMS}, got {cfg.norm!r}")


# ---------------------------------------------------------------------------
# Rope table
# ---------------------------------------------------------------------------

def build_ropes(cfg: ModelConfig, positions):
    """{theta: (cos, sin)} for every theta the layer pattern uses."""
    thetas = {cfg.rope_theta}
    if cfg.window is not None and cfg.window_pattern:
        thetas.add(cfg.rope_theta_local)
    dim = cfg.hd if cfg.mla is None else cfg.mla.d_rope
    return {th: rotary_cos_sin(positions, dim, theta=th,
                               dtype=cfg.compute_dtype)
            for th in sorted(thetas)}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_transformer_block(gen: torch.Generator, cfg: ModelConfig, *,
                           device=None):
    p = {"ln1": init_norm(cfg, cfg.d_model, device=device),
         "ln2": init_norm(cfg, cfg.d_model, device=device)}
    if cfg.mla is not None:
        p["attn"] = init_mla(gen, cfg.d_model, cfg.mla, device=device)
    else:
        p["attn"] = init_gqa(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.hd, qk_norm=cfg.qk_norm, bias=cfg.attn_bias,
                             device=device)
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, cfg.moe, device=device)
    else:
        p["mlp"] = init_glu_mlp(gen, cfg.d_model, cfg.d_ff, device=device)
    if cfg.post_norms:
        p["pn1"] = init_norm(cfg, cfg.d_model, device=device)
        p["pn2"] = init_norm(cfg, cfg.d_model, device=device)
    return p


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, *,
                     device=None):
    """Pre-norm ``ln`` and the mixer ``mix``: Mamba1 for the SSM family,
    Mamba2 for the hybrid."""
    ln = init_norm(cfg, cfg.d_model, device=device)
    if cfg.family == "ssm":
        return {"ln": ln, "mix": init_mamba1(gen, cfg.ssm1, device=device)}
    return {"ln": ln, "mix": init_mamba2(gen, cfg.ssm2, device=device)}


def init_whisper_block(gen: torch.Generator, cfg: ModelConfig, *,
                       cross: bool, device=None):
    """An encoder layer (``cross=False``) or a decoder layer: biased
    self-attention projections (``wo`` unbiased), a biased GELU MLP, and
    in the decoder ``lnx`` and the cross-attention."""
    p = {"ln1": init_norm(cfg, cfg.d_model, device=device),
         "attn": init_gqa(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.hd, bias=True, device=device),
         "ln2": init_norm(cfg, cfg.d_model, device=device),
         "mlp": init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, device=device)}
    if cross:
        p["lnx"] = init_norm(cfg, cfg.d_model, device=device)
        p["cross"] = init_cross_attn(gen, cfg.d_model, cfg.n_heads, cfg.hd,
                                     device=device)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device=None, cast: bool = False) -> dict:
    """fp32 parameters, drawn from ``gen`` with the JAX package's
    distributions: linear weights N(0, d_in^-0.5), the embedding and
    whisper's ``dec_pos`` N(0, init_std), RMSNorm weights zero, LayerNorm
    weights one and biases zero, the experts as ``init_moe``, the Mamba
    mixers as ``init_mamba1`` / ``init_mamba2``.  ``gen`` must live on
    ``device`` (default: the generator's own device).

    ``cast``: ``cast_params_once``'s tree, each layer cast as soon as it
    is drawn (the same draws), so a model whose fp32 parameters outgrow
    the device but whose compute-dtype copy fits can be served
    (qwen3-moe-30b-a3b: 120 GB in fp32, 61 GB in bf16)."""
    require_ported(cfg)
    device = gen.device if device is None else torch.device(device)

    def maybe_cast(p, at):
        return cast_params_once(p, cfg, at=at) if cast else p

    params: dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model,
                                std=cfg.init_std, device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab,
                                        std=cfg.init_std, device=device)
    params["final_norm"] = init_norm(cfg, cfg.d_model, device=device)
    if cfg.family == "encdec":
        def stack(key, n, cross):
            return [maybe_cast(init_whisper_block(gen, cfg, cross=cross,
                                                  device=device), (key, i))
                    for i in range(n)]

        params["enc_layers"] = stack("enc_layers", cfg.encoder_layers, False)
        params["dec_layers"] = stack("dec_layers", cfg.num_layers, True)
        params["enc_norm"] = init_norm(cfg, cfg.d_model, device=device)
        params["dec_pos"] = init_embedding(gen, cfg.max_positions,
                                           cfg.d_model, std=cfg.init_std,
                                           device=device)
        return cast_params_once(params, cfg) if cast else params
    if cfg.family in ("dense", "moe"):
        if cfg.num_layers % cfg.period:
            raise ValueError(f"{cfg.num_layers} layers do not fill periods "
                             f"of {cfg.period}")
        block = init_transformer_block
    else:
        if cfg.family == "hybrid":
            hybrid_groups(cfg)
        block = init_mamba_block

    params["layers"] = [maybe_cast(block(gen, cfg, device=device),
                                   ("layers", i))
                        for i in range(cfg.num_layers)]
    if cfg.family == "hybrid":
        params["shared_attn"] = init_transformer_block(gen, cfg,
                                                       device=device)
    return cast_params_once(params, cfg) if cast else params


def cast_params_once(params, cfg: ModelConfig, *, at: tuple = ()):
    """The reference's cast: every floating leaf of two dims or more *in
    the reference's tree* goes to the compute dtype, and ``A_log`` (whose
    ``exp`` sets the SSM decay) stays fp32.  The rule reads the
    reference's shapes (``convert.cast_paths``): the reference stacks each
    layer's leaves, so the per-layer vectors (norm weights, ``conv_b``,
    ``D``, ``dt_bias``, biases) are cast, while ``final_norm`` and the
    hybrid family's unstacked ``shared_attn`` norms stay fp32.  ``at`` is
    the path of ``params`` in the whole tree when a subtree is cast alone.
    Leaves already in that dtype are returned as they are, so a tree cast
    once before a loop is not copied again by every call."""
    from repro_torch import convert       # convert imports this module
    dt, cast = cfg.compute_dtype, convert.cast_paths(cfg)
    leaves, spec = tree_flatten(params)
    return tree_unflatten(
        [x.to(dt) if at + path in cast and x.is_floating_point() else x
         for path, x in zip(convert.tree_paths(params), leaves)], spec)


def lm_head_weight(params, cfg: ModelConfig):
    """``(vocab, d_model)``: the LM head in the ``(d_out, d_in)`` layout."""
    if cfg.tie_embeddings:
        return params["embed"]["table"]
    return params["lm_head"]["w"]


def embed_tokens(params, tokens, cfg: ModelConfig):
    scale = cfg.d_model ** 0.5 if cfg.embed_scale else None
    return embedding_apply(params["embed"], tokens,
                           dtype=cfg.compute_dtype, scale=scale)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------

def _ckpt(fn, *args):
    """Non-reentrant ``torch.utils.checkpoint``; the blocks draw no random
    numbers, so no RNG state is saved."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _qkv_part(p):
    """The leaves of a layer that its q / k / v projection reads (MLA's
    ``wq``, ``kv_down``, ``kv_norm`` and ``kv_up``)."""
    attn = {k: v for k, v in p["attn"].items() if k != "wo"}
    return {"ln1": p["ln1"], "attn": attn}


def _out_part(p):
    """The leaves of a layer after its attention call."""
    out = {k: v for k, v in p.items() if k not in ("ln1", "attn")}
    out["attn"] = {"wo": p["attn"]["wo"]}
    return out


def apply_transformer_block(p, x, ropes, rt, cfg: ModelConfig,
                            kind: AttnKind, doc_start=None, gather=None):
    """Returns ``(x, aux)``; aux is the MoE layer's (zero for the dense
    family).  ``gather`` (None on one device) turns a dict of this rank's
    shards into the full leaves; it runs inside each checkpointed
    function, so under remat the recompute gathers, and exchanges the MoE
    tokens, again, in the same order on every rank."""
    cos, sin = ropes.get(kind.rope_theta, (None, None))
    if cfg.mla is not None:
        def project(a, h):
            return mla_project(a, h, cos, sin, cfg.mla)[:3]
        attend = functools.partial(mla_attend, rt=rt, kind=kind, m=cfg.mla,
                                   zigzag=cfg.zigzag, doc_start=doc_start)
    else:
        def project(a, h):
            return _project_qkv(a, h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                cos, sin, kind, qk_norm=cfg.qk_norm)
        attend = functools.partial(gqa_attend, rt=rt, kind=kind,
                                   zigzag=cfg.zigzag, doc_start=doc_start)

    def leaves(part=None):
        """The layer's leaves that ``part`` picks (all by default), full."""
        if gather is None:
            return p
        return gather(p if part is None else part(p))

    def mlp_half(q, x, h):
        """The residual, the MLP (or MoE) and its residual: ``(x,
        aux)``."""
        if cfg.post_norms:
            h = apply_norm(cfg, q["pn1"], h)
        x = x + h
        h = apply_norm(cfg, q["ln2"], x)
        if cfg.family == "moe":
            h, aux = moe_apply(q["moe"], h, rt, cfg.moe)
        else:
            h = glu_mlp_apply(q["mlp"], h, act=cfg.act)
            aux = x.new_zeros((), dtype=torch.float32)
        if cfg.post_norms:
            h = apply_norm(cfg, q["pn2"], h)
        return x + h, aux

    def block(x):
        q = leaves()
        h = attend(*project(q["attn"], apply_norm(cfg, q["ln1"], x)))
        return mlp_half(q, x, linear_apply(q["attn"]["wo"], h))

    def qkv(x):
        q = leaves(_qkv_part)
        return project(q["attn"], apply_norm(cfg, q["ln1"], x))

    def out_half(x, attn_out):
        q = leaves(_out_part)
        return mlp_half(q, x, linear_apply(q["attn"]["wo"], attn_out))

    policy = remat_policy(cfg.remat)
    if policy == "none":
        with (gather.out_of_saved() if gather is not None
              else contextlib.nullcontext()):
            return block(x)
    if policy == "full":
        return _ckpt(block, x)
    return _ckpt(out_half, x, attend(*_ckpt(qkv, x)))


def apply_mamba_block(p, x, rt, cfg: ModelConfig, gather=None):
    """``x + mixer(norm(x))``, the mixer Mamba1 (SSM family) or Mamba2
    (hybrid); ``gather`` as in ``apply_transformer_block``.  Under
    ``full`` and ``scpp`` the block is checkpointed whole."""
    def block(x):
        q = p if gather is None else gather(p)
        h = apply_norm(cfg, q["ln"], x)
        if cfg.family == "ssm":
            return x + mamba1_apply(q["mix"], h, rt, cfg.ssm1)
        return x + mamba2_apply(q["mix"], h, rt, cfg.ssm2)

    if remat_policy(cfg.remat) == "none":
        with (gather.out_of_saved() if gather is not None
              else contextlib.nullcontext()):
            return block(x)
    return _ckpt(block, x)


def backbone(params, x, ropes, rt, cfg: ModelConfig, doc_start=None,
             gather=None):
    """Embedded input -> final hidden states.  Returns ``(x, aux)``.
    ``doc_start`` (packed documents: a ``(B, S)`` int32 table of each
    token's document start) reaches only the attention of the dense and
    MoE families (the plan refuses packing for the others); ``gather`` as
    in ``apply_transformer_block``."""
    require_ported(cfg)
    aux = x.new_zeros((), dtype=torch.float32)
    if cfg.family in ("dense", "moe"):
        for i, lp in enumerate(params["layers"]):
            x, a = apply_transformer_block(lp, x, ropes, rt, cfg,
                                           cfg.attn_kind(i % cfg.period),
                                           doc_start=doc_start,
                                           gather=gather)
            aux = aux + a
        return x, aux
    shared = None
    if cfg.family == "hybrid":
        groups, _ = hybrid_groups(cfg)
        shared = params["shared_attn"]
        if gather is not None:
            shared = gather(shared)
    for i, lp in enumerate(params["layers"]):
        x = apply_mamba_block(lp, x, rt, cfg, gather=gather)
        if shared is not None and i < groups * cfg.attn_every \
                and (i + 1) % cfg.attn_every == 0:
            x, a = apply_transformer_block(shared, x, ropes, rt, cfg,
                                           cfg.attn_kind(0))
            aux = aux + a
    return x, aux


ENC_KIND = AttnKind(causal=False, rope=False)
DEC_KIND = AttnKind(causal=True, rope=False)


def _enc_out_part(p):
    return {"attn": {"wo": p["attn"]["wo"]}, "ln2": p["ln2"],
            "mlp": p["mlp"]}


def _dec_mid_part(p):
    """What a decoder layer reads between its two attention calls."""
    return {"attn": {"wo": p["attn"]["wo"]}, "lnx": p["lnx"],
            "cross": {k: v for k, v in p["cross"].items() if k != "wo"}}


def _dec_tail_part(p):
    return {"cross": {"wo": p["cross"]["wo"]}, "ln2": p["ln2"],
            "mlp": p["mlp"]}


def apply_whisper_block(p, x, enc, rt, cfg: ModelConfig, gather=None):
    """An encoder layer (``enc`` None: non-causal self-attention on the
    contiguous layout) or a decoder layer (causal self-attention on the
    zigzag layout, then cross-attention over ``enc``), each with its GELU
    MLP; ``gather`` as in ``apply_transformer_block``.  Under ``scpp`` the
    layer is checkpointed around its attention calls: each piece gathers
    only the leaves it reads."""
    kind, zigzag = (ENC_KIND, False) if enc is None else (DEC_KIND,
                                                          cfg.zigzag)

    def leaves(part=None):
        if gather is None:
            return p
        return gather(p if part is None else part(p))

    def mlp(q, x):
        return x + gelu_mlp_apply(q["mlp"], apply_norm(cfg, q["ln2"], x))

    def block(x, enc):
        q = leaves()
        x = x + gqa_apply(q["attn"], apply_norm(cfg, q["ln1"], x), None,
                          None, rt, kind, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                          zigzag=zigzag)
        if enc is not None:
            x = x + cross_attn_apply(q["cross"], apply_norm(cfg, q["lnx"], x),
                                     enc, rt, n_heads=cfg.n_heads,
                                     head_dim=cfg.hd)
        return mlp(q, x)

    policy = remat_policy(cfg.remat)
    if policy == "none":
        with (gather.out_of_saved() if gather is not None
              else contextlib.nullcontext()):
            return block(x, enc)
    if policy == "full":
        return _ckpt(block, x, enc)

    def qkv(x):
        q = leaves(_qkv_part)
        return _project_qkv(q["attn"], apply_norm(cfg, q["ln1"], x),
                            cfg.n_heads, cfg.n_kv_heads, cfg.hd, None, None,
                            kind, qk_norm=False)

    attn_out = gqa_attend(*_ckpt(qkv, x), rt, kind, zigzag=zigzag)
    if enc is None:
        def out_half(x, attn_out):
            q = leaves(_enc_out_part)
            return mlp(q, x + linear_apply(q["attn"]["wo"], attn_out))

        return _ckpt(out_half, x, attn_out)

    def mid(x, attn_out, enc):
        q = leaves(_dec_mid_part)
        x = x + linear_apply(q["attn"]["wo"], attn_out)
        return (x,) + project_cross(q["cross"], apply_norm(cfg, q["lnx"], x),
                                    enc, n_heads=cfg.n_heads,
                                    head_dim=cfg.hd)

    x, cq, ck, cv = _ckpt(mid, x, attn_out, enc)
    cross_out = cross_attend(cq, ck, cv, rt)

    def tail(x, cross_out):
        q = leaves(_dec_tail_part)
        return mlp(q, x + linear_apply(q["cross"]["wo"], cross_out))

    return _ckpt(tail, x, cross_out)


def whisper_encoder(params, frames, rt, cfg: ModelConfig, gather=None):
    """frames ``(B, T_enc, D)``: this rank's contiguous piece of the
    stubbed conv frontend's output, to which its slice of the sinusoid
    table is added."""
    dt = cfg.compute_dtype
    n = frames.shape[1] * rt.pc.sp
    table = sinusoid_positions(n, cfg.d_model, dt, device=frames.device)
    x = frames.to(dt) + table[seq_slice(rt.pc, rt.coord, n)][None]
    for lp in params["enc_layers"]:
        x = apply_whisper_block(lp, x, None, rt, cfg, gather=gather)
    norm = params["enc_norm"] if gather is None else gather(
        params["enc_norm"])
    return apply_norm(cfg, norm, x)


def whisper_decoder(params, x, enc, rt, cfg: ModelConfig, positions,
                    gather=None):
    """The embedded tokens ``x`` plus the learned positions (clamped to
    ``max_positions - 1``), then the decoder layers over ``enc``."""
    pos = params["dec_pos"] if gather is None else gather(params["dec_pos"])
    x = x + embedding_apply(pos, positions.clamp(max=cfg.max_positions - 1),
                            dtype=x.dtype)
    for lp in params["dec_layers"]:
        x = apply_whisper_block(lp, x, enc, rt, cfg, gather=gather)
    return x


def _chunk_logits(xc, w, cap: float):
    """A chunk's fp32 logits, soft-capped in place."""
    logits = F.linear(xc, w.to(xc.dtype)).float()
    if cap:
        logits.div_(cap).tanh_().mul_(cap)
    return logits


class _XentChunk(torch.autograd.Function):
    """One chunk's summed token loss and valid-token count.  Like the
    reference's ``jax.checkpoint(chunk_fn)`` it keeps only its inputs and
    the row lse, and recomputes the logits in the backward; there it
    forms ``softmax - onehot`` in place in the one fp32 logits buffer, so
    a chunk's backward holds its fp32 logits once (autograd's chain would
    hold them, their exp and the gather's scatter at once)."""

    @staticmethod
    def forward(ctx, xc, w, lc, cap: float):
        logits = _chunk_logits(xc, w, cap)
        valid = lc >= 0
        idx = lc.clamp(min=0)[:, None]
        ll = logits.gather(1, idx)[:, 0]
        m = logits.amax(dim=-1)
        lse = logits.sub_(m[:, None]).exp_().sum(dim=-1).log_().add_(m)
        del logits
        ctx.save_for_backward(xc, w, idx, valid, lse)
        ctx.cap, ctx.w_dtype = cap, w.dtype
        n_valid = valid.sum().float()
        ctx.mark_non_differentiable(n_valid)
        return torch.where(valid, lse - ll, 0.0).sum(), n_valid

    @staticmethod
    def backward(ctx, g, _):
        xc, w, idx, valid, lse = ctx.saved_tensors
        cap = ctx.cap
        logits = _chunk_logits(xc, w, cap)
        # d(capped)/d(raw) = 1 - tanh^2, from the capped logits
        dcap = 1.0 - (logits / cap) ** 2 if cap else None
        dl = logits.sub_(lse[:, None]).exp_()
        dl.scatter_add_(1, idx, torch.full_like(lse[:, None], -1.0))
        dl.mul_((g * valid)[:, None])
        if cap:
            dl.mul_(dcap)
            del dcap
        dl = dl.to(xc.dtype)
        return (dl @ w.to(xc.dtype), (dl.t() @ xc).to(ctx.w_dtype), None,
                None)


def chunked_xent(x, w_head, labels, rt, cfg: ModelConfig):
    """x ``(B, S, D)``; w_head ``(V, D)``; labels ``(B, S)`` (-1 = pad).
    Returns ``(loss_sum, n_valid)`` fp32 scalars.  Each chunk of
    ``cfg.loss_chunk`` tokens keeps no logits for the backward, as the
    reference's ``jax.checkpoint(chunk_fn)``: its fp32 logits are
    recomputed there (``_XentChunk``)."""
    b, s, d = x.shape
    t = b * s
    chunk = min(cfg.loss_chunk, t)
    while t % chunk:
        chunk -= 1
    xt, lt = x.reshape(t, d), labels.reshape(t)
    loss_sum = x.new_zeros((), dtype=torch.float32)
    n_valid = x.new_zeros((), dtype=torch.float32)
    for c0 in range(0, t, chunk):
        ls, nv = _XentChunk.apply(xt[c0:c0 + chunk], w_head,
                                  lt[c0:c0 + chunk], cfg.final_softcap)
        loss_sum = loss_sum + ls
        n_valid = n_valid + nv
    return loss_sum, n_valid


def forward_loss(params, batch, rt, cfg: ModelConfig, gather=None):
    """batch: ``{tokens, labels, positions}``, ``doc_start`` for packed
    documents and ``frames`` for the encoder-decoder family -> ``(loss,
    metrics)``.

    On a mesh the batch is this rank's shard, and the loss and
    ``n_tokens`` are global: the summed loss and the valid-token count are
    summed over every rank (the count without a grad).  The summed loss's
    backward is the identity (``sum_over_world``), so each rank's
    parameter grads are its own tokens' share of the global loss's grad,
    and their sum over ranks is the one-device grad.

    With ``gather`` (hybrid ZeRO, ``core/zero.py::GatherAtUse``) the
    params are this rank's shards and each is gathered at its use.  The
    tied table is gathered once, for the embedding and the LM head both,
    so its grad is reduced once, after both uses have added to it."""
    params = cast_params_once(params, cfg)
    full = gather if gather is not None else (lambda t: t)
    embed = full(params["embed"])
    x = embed_tokens({"embed": embed}, batch["tokens"], cfg)
    w_head = embed["table"] if cfg.tie_embeddings else None
    del embed
    if cfg.family == "encdec":
        enc = whisper_encoder(params, batch["frames"], rt, cfg, gather)
        x = whisper_decoder(params, x, enc, rt, cfg, batch["positions"],
                            gather)
        aux = x.new_zeros((), dtype=torch.float32)
    else:
        ropes = build_ropes(cfg, batch["positions"]) if cfg.rope else {}
        x, aux = backbone(params, x, ropes, rt, cfg,
                          doc_start=batch.get("doc_start"), gather=gather)
    x = apply_norm(cfg, full(params["final_norm"]), x)
    if w_head is None:
        w_head = full(params["lm_head"])["w"]
    loss_sum, n_valid = chunked_xent(x, w_head, batch["labels"], rt, cfg)
    if rt.mesh is not None:
        loss_sum = sum_over_world(loss_sum, rt)
        n_valid = all_reduce_(n_valid.detach(), rt)
    xent = loss_sum / n_valid.clamp(min=1.0)
    loss = xent + aux
    return loss, {"loss": loss, "xent": xent, "aux": aux,
                  "n_tokens": n_valid}
