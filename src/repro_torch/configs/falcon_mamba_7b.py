"""falcon-mamba-7b [ssm] 64 Mamba1 layers, d_model 4096, d_inner 8192,
d_state 16, d_conv 4, dt_rank 256, vocab 65024, untied head, no attention
(counterpart of ``src/repro/configs/falcon_mamba_7b.py``).  The sequence
stays sharded over every sequence axis and the scan crosses the pieces
through the state hand-off (``models/ssm.py``)."""
from repro_torch.models.model import ModelConfig
from repro_torch.models.ssm import Mamba1Dims


def config():
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm", num_layers=64, d_model=4096,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab=65024, rope=False,
        tie_embeddings=False, zigzag=False,
        ssm1=Mamba1Dims(d_model=4096, d_inner=8192, d_state=16, d_conv=4,
                        seg=16))


def reduced():
    return ModelConfig(
        name="falcon-mamba-smoke", family="ssm", num_layers=2, d_model=64,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab=512, rope=False,
        tie_embeddings=False, zigzag=False, dtype="float32", loss_chunk=64,
        ssm1=Mamba1Dims(d_model=64, d_inner=128, d_state=8, d_conv=4,
                        seg=8))
