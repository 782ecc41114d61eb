"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave with MoE
(16 experts, top-2) on every other layer [arXiv:2403.19887].

Block group of 8 layers: attention at position 4 (as in the Jamba paper's
block figure), Mamba elsewhere; MoE FFN on odd positions, dense FFN on even.
"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe_pattern="odd",
    tie_embeddings=False,
    moe=MoEConfig(num_experts=16, top_k=2, num_shared=0, d_ff_expert=24576),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=512),
    source="arXiv:2403.19887 + Jamba-1.5 (72L d8192 64H kv8, 16e top2, 1:7)",
)
