"""granite-20b — code model, llama-style stack with MQA (kv=1)
[arXiv:2405.04324]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    arch_type="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp="gelu",  # non-gated FFN: gated-3-matrix would overshoot 20B -> 28B
    norm="rmsnorm",
    tie_embeddings=False,
    source="arXiv:2405.04324 (Granite-20B code: 52L d6144 48H MQA)",
)
