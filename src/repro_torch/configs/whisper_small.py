"""whisper-small [audio] encoder-decoder, 12 + 12 layers, d_model=768,
12 heads (MHA), d_ff=3072, vocab=51865, LayerNorm, no RoPE, tied
embeddings, bf16.  The conv frontend is a stub, as in the reference: the
model takes precomputed frame embeddings ``(B, 1536, d_model)`` (1500
frames padded to a multiple of 16).  The decoder keeps the reference's
``max_positions = 32768`` learned positions (counterpart of
``src/repro/configs/whisper_small.py``)."""
from repro_torch.models.model import ModelConfig


def config():
    return ModelConfig(
        name="whisper-small", family="encdec", num_layers=12,
        encoder_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab=51865, norm="ln", rope=False,
        enc_frames=1536, max_positions=32768, tie_embeddings=True)


def reduced():
    return ModelConfig(
        name="whisper-smoke", family="encdec", num_layers=2,
        encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, norm="ln", rope=False, enc_frames=32, max_positions=128,
        tie_embeddings=True, dtype="float32", loss_chunk=64)
