"""command-r-35b [dense] — Cohere, GQA kv=8, no biases, tied embeddings.

[hf:CohereForAI/c4ai-command-r-v01].  40L, d_model=8192, 64 heads,
d_ff=22528, vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    arch_type="dense",
    num_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_528,
    vocab=256_000,
    act="silu",
    mlp_gated=True,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
    max_seq_len=131_072,
    citation="hf:CohereForAI/c4ai-command-r-v01",
)
