"""deepseek-v2-lite-16b [moe] 27L d_model=2048 16H d_ff=1408 vocab=102400,
MoE 64 experts top-6 with 2 shared experts (one GLU of twice the width)
and unnormalised top-k weights, MLA (kv_lora 512, d_nope 128, d_rope 64,
d_v 128), untied head (counterpart of
``src/repro/configs/deepseek_v2_lite_16b.py``: all 27 layers MoE, as
there).  Q and K are 192 wide, so the kernels run at D 192."""
from repro_torch.models.attention_block import MLADims
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEDims


def config():
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", num_layers=27,
        d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408, vocab=102400,
        tie_embeddings=False,
        mla=MLADims(n_heads=16, kv_lora=512, d_nope=128, d_rope=64,
                    d_v=128),
        moe=MoEDims(d_model=2048, n_experts=64, top_k=6, d_ff=1408,
                    n_shared=2, norm_topk=False))


def reduced():
    return ModelConfig(
        name="deepseek-v2-lite-smoke", family="moe", num_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=64, vocab=512,
        tie_embeddings=False, dtype="float32", loss_chunk=64,
        mla=MLADims(n_heads=4, kv_lora=32, d_nope=16, d_rope=8, d_v=16),
        moe=MoEDims(d_model=64, n_experts=8, top_k=2, d_ff=64,
                    n_shared=1, capacity_factor=8.0, norm_topk=False))
