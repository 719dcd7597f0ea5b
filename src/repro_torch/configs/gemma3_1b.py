"""gemma3-1b [dense] — 5:1 local:global interleave, 262k vocab, 128k ctx.

[hf:google/gemma-3-1b-pt].  26L, d_model=1152, 4 heads (GQA kv=1, MQA),
head_dim=256, d_ff=6912, sliding window 1024 on the 5 local layers of each
period, qk-norm.  26 = 4 * (5L+1G) + 2 trailing local layers (handled as
scan remainder).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    arch_type="dense",
    num_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262_144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    sliding_window=1024,
    use_qk_norm=True,
    act="gelu",
    mlp_gated=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
    citation="hf:google/gemma-3-1b-pt",
)

# 5/6 of layers are natively sliding-window; global layers fall back to the
# windowed variant at 500k (see DESIGN.md §4).
LONG_CTX = "native_window"
