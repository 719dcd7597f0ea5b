"""granite-20b [dense] — IBM granite code model, llama-style, MQA.

[arXiv:2405.04324].  52L, d_model=6144, 48 heads (GQA kv=1 => MQA),
d_ff=24576 (4x, non-gated GELU), vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    arch_type="dense",
    num_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24_576,
    vocab=49_152,
    act="gelu",
    mlp_gated=False,
    tie_embeddings=False,
    rope_theta=10_000.0,
    max_seq_len=8_192 * 16,
    citation="arXiv:2405.04324",
)
