"""gemma3-12b [dense] 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144: five local layers (window 1024, RoPE theta 1e4) to one
global (theta 1e6), qk-norm, post-norms, embedding scale, tanh-GELU,
tied embeddings, bf16.  No ``head_dim`` is set, so it is 3840 / 16 = 240,
which the kernels pad to 256 (counterpart of
``src/repro/configs/gemma3_12b.py``)."""
from repro_torch.models.model import ModelConfig


def config():
    return ModelConfig(
        name="gemma3-12b", family="dense", num_layers=48, d_model=3840,
        n_heads=16, n_kv_heads=8, d_ff=15360, vocab=262144,
        qk_norm=True, window=1024, window_pattern=6,
        rope_theta=1e6, rope_theta_local=1e4, post_norms=True,
        embed_scale=True, act="gelu", tie_embeddings=True)


def reduced():
    return ModelConfig(
        name="gemma3-12b-smoke", family="dense", num_layers=6, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
        qk_norm=True, window=16, window_pattern=6,
        rope_theta=1e6, rope_theta_local=1e4, post_norms=True,
        embed_scale=True, act="gelu", dtype="float32", loss_chunk=64)
