"""chameleon-34b [vlm] 48L d_model=8192 64H (GQA kv=8, head dim 128)
d_ff=22016 vocab=65536: qk-norm, an untied LM head, 4096-token loss
chunks, bf16.  Early fusion: image patches arrive as VQ codes inside the
token vocabulary, so the model takes plain token ids (counterpart of
``src/repro/configs/chameleon_34b.py``)."""
from repro_torch.models.model import ModelConfig


def config():
    return ModelConfig(
        name="chameleon-34b", family="dense", num_layers=48, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=22016, vocab=65536,
        qk_norm=True, tie_embeddings=False, loss_chunk=4096)


def reduced():
    return ModelConfig(
        name="chameleon-34b-smoke", family="dense", num_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
        qk_norm=True, tie_embeddings=False, dtype="float32", loss_chunk=64)
