"""olmo-1b [dense] 16L d_model=2048 16H (MHA kv=16) d_ff=8192
vocab=50304: non-parametric LayerNorm, tied embeddings, bf16
(counterpart of ``src/repro/configs/olmo_1b.py``)."""
from repro_torch.models.model import ModelConfig


def config():
    return ModelConfig(
        name="olmo-1b", family="dense", num_layers=16, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=8192, vocab=50304,
        norm="ln_np", tie_embeddings=True)


def reduced():
    return ModelConfig(
        name="olmo-1b-smoke", family="dense", num_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        norm="ln_np", dtype="float32", loss_chunk=64)
