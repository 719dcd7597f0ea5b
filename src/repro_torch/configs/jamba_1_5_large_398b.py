"""jamba-1.5-large-398b [hybrid] — Mamba:attention 7:1, MoE 16e top-2.

[arXiv:2403.19887].  72L = 9 superblocks of 8 (attention at period
position 4, Mamba elsewhere); MoE FFN on every other layer (16 experts,
top-2).  d_model=8192, 64 heads (GQA kv=8), d_ff=24576, vocab=65536;
Mamba d_inner 16384, d_state 16, dt_rank 512, d_conv 4.  Its 398.6e9
parameters do not fit one card: ``chip_smoke.py`` runs the first 5
layers (``dataclasses.replace(CONFIG, num_layers=5)``, 24.0e9 parameters),
which hold every kind of layer the model has.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab=65_536,
    layer_pattern=(
        "mamba", "mamba", "mamba", "mamba",
        "global", "mamba", "mamba", "mamba",
    ),
    num_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    d_state=16,
    d_conv=4,
    expand=2,
    act="silu",
    mlp_gated=True,
    tie_embeddings=False,
    max_seq_len=262_144,
    citation="arXiv:2403.19887",
)
