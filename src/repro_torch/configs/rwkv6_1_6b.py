"""rwkv6-1.6b "Finch" [ssm] — attention-free, data-dependent decay.

[arXiv:2404.05892].  24L, d_model=2048 (32 heads of size 64), channel-mix
d_ff=7168, vocab=65536, layernorm.  The prefill runs its WKV recurrence
through K7 (``kernels/rwkv6_scan.py``); decode carries an O(1) state.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    num_layers=24,
    d_model=2048,
    n_heads=32,          # rwkv heads (d_model / rwkv_head_size)
    n_kv_heads=32,
    d_ff=7168,
    vocab=65_536,
    ssm_kind="rwkv6",
    rwkv_head_size=64,
    rwkv_decay_lora=64,
    norm="layernorm",
    tie_embeddings=False,
    max_seq_len=1_048_576,
    citation="arXiv:2404.05892",
)
