"""qwen3-moe-30b-a3b [moe] 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8, qk-norm, RoPE theta 1e6, untied head
(counterpart of ``src/repro/configs/qwen3_moe_30b_a3b.py``; head_dim =
d_model / H = 64)."""
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEDims


def config():
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe", num_layers=48,
        d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768, vocab=151936,
        qk_norm=True, rope_theta=1e6, tie_embeddings=False,
        moe=MoEDims(d_model=2048, n_experts=128, top_k=8, d_ff=768,
                    norm_topk=True))


def reduced():
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe", num_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=64, vocab=512, qk_norm=True,
        tie_embeddings=False, dtype="float32", loss_chunk=64,
        moe=MoEDims(d_model=64, n_experts=8, top_k=2, d_ff=64,
                    capacity_factor=8.0, norm_topk=True))
