"""zamba2-7b [hybrid] 81 Mamba2 layers, d_model 3584, d_inner 7168,
d_state 64, head_dim 64 (112 SSM heads); one shared transformer block (32
/ 32 heads of dim 112, d_ff 14336) after every 6th Mamba layer: 13
applications and 3 tail layers; vocab 32000, untied head (counterpart of
``src/repro/configs/zamba2_7b.py``).  Contiguous (non-zigzag) ring
attention: the SSM layers need contiguous sequence pieces."""
from repro_torch.models.model import ModelConfig
from repro_torch.models.ssm import Mamba2Dims


def config():
    return ModelConfig(
        name="zamba2-7b", family="hybrid", num_layers=81, d_model=3584,
        n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
        attn_every=6, zigzag=False, tie_embeddings=False,
        ssm2=Mamba2Dims(d_model=3584, d_inner=7168, d_state=64,
                        head_dim=64, seg=16))


def reduced():
    return ModelConfig(
        name="zamba2-smoke", family="hybrid", num_layers=7, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        attn_every=3, zigzag=False, tie_embeddings=False, dtype="float32",
        loss_chunk=64,
        ssm2=Mamba2Dims(d_model=64, d_inner=128, d_state=8, head_dim=16,
                        seg=8))
