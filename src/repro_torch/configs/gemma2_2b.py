"""gemma2-2b [dense] 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000: local (window 4096) and global layers alternating, attention
softcap 50 and final softcap 30, post-norms, embedding scale, tanh-GELU,
tied embeddings, bf16.  No ``head_dim`` is set, so it is 2304 / 8 = 288
(counterpart of ``src/repro/configs/gemma2_2b.py``)."""
from repro_torch.models.model import ModelConfig


def config():
    return ModelConfig(
        name="gemma2-2b", family="dense", num_layers=26, d_model=2304,
        n_heads=8, n_kv_heads=4, d_ff=9216, vocab=256000,
        window=4096, window_pattern=2, attn_softcap=50.0,
        final_softcap=30.0, post_norms=True, embed_scale=True,
        act="gelu", tie_embeddings=True)


def reduced():
    return ModelConfig(
        name="gemma2-2b-smoke", family="dense", num_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
        window=16, window_pattern=2, attn_softcap=50.0, final_softcap=30.0,
        post_norms=True, embed_scale=True, act="gelu", dtype="float32",
        loss_chunk=64)
