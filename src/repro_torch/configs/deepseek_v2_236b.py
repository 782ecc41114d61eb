"""deepseek-v2-236b — MLA (kv_lora=512, q_lora=1536) + MoE 160 routed
top-6 with 2 shared experts [arXiv:2405.04434].

Deviation from the released model: every layer is MoE (the release uses a
dense FFN in layer 1); the assigned config specifies uniform 160e top-6.
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    moe_pattern="all",
    tie_embeddings=False,
    moe=MoEConfig(num_experts=160, top_k=6, num_shared=2, d_ff_expert=1536),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    source="arXiv:2405.04434 (DeepSeek-V2: 60L d5120 128H, MLA 512, 160e top6)",
)
