"""gemma2-27b [dense] — alternating local/global attention, logit softcaps.

[arXiv:2408.00118].  46L = 23 x (local, global), d_model=4608, 32 heads
(GQA kv=16), head_dim=128, d_ff=36864, vocab=256000, sliding window 4096,
attention softcap 50, final logit softcap 30.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    arch_type="dense",
    num_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    vocab=256_000,
    layer_pattern=("local", "global"),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    act="gelu",
    mlp_gated=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    max_seq_len=8192 * 16,
    citation="arXiv:2408.00118",
)
