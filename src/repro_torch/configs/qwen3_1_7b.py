"""qwen3-1.7b [dense] 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936: qk-norm, RoPE theta 1e6, tied embeddings, bf16
(counterpart of ``src/repro/configs/qwen3_1_7b.py``)."""
from repro_torch.models.model import ModelConfig


def config():
    return ModelConfig(
        name="qwen3-1.7b", family="dense", num_layers=28, d_model=2048,
        n_heads=16, n_kv_heads=8, d_ff=6144, vocab=151936,
        qk_norm=True, rope_theta=1e6, tie_embeddings=True,
        loss_chunk=2048)


def reduced():
    return ModelConfig(
        name="qwen3-1.7b-smoke", family="dense", num_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
        qk_norm=True, rope_theta=1e6, dtype="float32", loss_chunk=64)
