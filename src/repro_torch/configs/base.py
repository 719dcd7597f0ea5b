"""Model configuration schema, the port's copy of ``repro.configs.base``.

One ``ModelConfig`` describes any architecture of the JAX package (dense,
MoE, SSM, hybrid, encoder-decoder audio, VLM); the port runs the decoder
kinds (``global``/``local`` attention, ``mamba`` and ``rwkv`` mixers,
``dense`` and ``moe`` FFNs), not the audio encoder-decoder or the VLM
front end.  Layer heterogeneity is expressed through ``layer_kinds()`` /
``ffn_kinds()``; ``block_len`` is the pattern's period, kept so that
``convert`` can unstack the reference's superblock parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # ---- attention options -------------------------------------------------
    # per-layer attention pattern, cycled: entries "global", "local", "mamba",
    # "rwkv".  None => all "global" (or all ssm_kind for arch_type == "ssm").
    layer_pattern: Optional[Tuple[str, ...]] = None
    sliding_window: int = 4096
    attn_logit_softcap: Optional[float] = None   # gemma2: 50.0
    final_logit_softcap: Optional[float] = None  # gemma2: 30.0
    rope_theta: float = 10_000.0
    use_rope: bool = True        # whisper uses learned positions instead
    use_qk_norm: bool = False

    # ---- FFN / MoE ----------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1            # layer i uses MoE iff i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    mlp_gated: bool = True        # swiglu-style gate
    act: str = "silu"             # silu | gelu | relu

    # ---- SSM ----------------------------------------------------------------
    ssm_kind: Optional[str] = None  # "rwkv6" | "mamba"
    d_state: int = 16             # mamba state / rwkv head size source
    d_conv: int = 4
    expand: int = 2               # mamba d_inner = expand * d_model
    rwkv_head_size: int = 64
    rwkv_decay_lora: int = 64

    # ---- encoder-decoder (audio) --------------------------------------------
    encoder_layers: int = 0
    source_len: int = 1500        # stub frames after the conv frontend
    frontend_dim: Optional[int] = None  # stub embedding dim (None => d_model)

    # ---- VLM ----------------------------------------------------------------
    num_patches: int = 0          # stub patch embeddings prepended to text

    # ---- misc ---------------------------------------------------------------
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    tie_embeddings: bool = True
    max_seq_len: int = 131_072
    dtype: str = "bfloat16"
    citation: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived layer structure -------------------------------------------
    def layer_kinds(self) -> Tuple[str, ...]:
        """Attention/mixer kind per layer, length num_layers."""
        if self.layer_pattern is None:
            if self.arch_type == "ssm":
                kind = {"rwkv6": "rwkv", "mamba": "mamba"}[self.ssm_kind or "rwkv6"]
                base = (kind,)
            else:
                base = ("global",)
        else:
            base = self.layer_pattern
        reps = -(-self.num_layers // len(base))
        return (base * reps)[: self.num_layers]

    def ffn_kinds(self) -> Tuple[str, ...]:
        """FFN kind per layer: "dense" | "moe" | "none" (rwkv has channel-mix
        built into its block, flagged "rwkv")."""
        kinds = []
        for i in range(self.num_layers):
            if self.layer_kinds()[i] == "rwkv":
                kinds.append("rwkv")
            elif self.num_experts > 0 and i % self.moe_every == self.moe_offset:
                kinds.append("moe")
            else:
                kinds.append("dense")
        return tuple(kinds)

    @property
    def block_len(self) -> int:
        """Smallest period of the (layer, ffn) kind pattern."""
        kinds = list(zip(self.layer_kinds(), self.ffn_kinds()))
        n = len(kinds)
        for p in range(1, n + 1):
            if all(kinds[i] == kinds[i % p] for i in range(n)):
                return p
        return n

    @property
    def num_superblocks(self) -> int:
        return self.num_layers // self.block_len

    @property
    def rem_layers(self) -> int:
        return self.num_layers % self.block_len

    # ---- sizes ---------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(self.d_model // 16, 8)

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def param_count(self) -> int:
        """Analytic total parameter count, the reference's (which leaves
        out the final norm)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        total = V * D  # embeddings
        if not self.tie_embeddings:
            total += V * D
        for lk, fk in zip(self.layer_kinds(), self.ffn_kinds()):
            total += 2 * D  # norms
            if lk in ("global", "local"):
                total += D * (self.n_heads * hd) * 2  # wq, wo
                total += D * (self.n_kv_heads * hd) * 2  # wk, wv
            elif lk == "mamba":
                di, ds, dr = self.d_inner, self.d_state, self.dt_rank
                total += D * 2 * di + self.d_conv * di + di * (dr + 2 * ds)
                total += dr * di + di * ds + di + di * D
            elif lk == "rwkv":
                # time-mix: 5 token-shift mixes + decay lora + r/k/v/g/o + ln
                lora = self.rwkv_decay_lora
                total += 6 * D + 2 * (D * lora + lora * D) + 5 * D * D + 2 * D
            if fk == "dense":
                total += (3 if self.mlp_gated else 2) * D * F
            elif fk == "moe":
                mults = 3 if self.mlp_gated else 2
                total += D * self.num_experts + self.num_experts * mults * D * F
            elif fk == "rwkv":
                total += 2 * D + D * F + F * D + D * D  # channel-mix
        if self.encoder_layers:
            enc = self.encoder_layers * (
                2 * D + 4 * D * (self.n_heads * hd) + 2 * D * F + 2 * D
            )
            total += enc + self.num_layers * (D + 4 * D * (self.n_heads * hd))
        if self.num_patches:
            total += D * D  # patch projector
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of num_experts)."""
        if self.num_experts == 0:
            return self.param_count()
        mults = 3 if self.mlp_gated else 2
        per_expert = mults * self.d_model * self.d_ff
        n_moe = sum(1 for k in self.ffn_kinds() if k == "moe")
        return int(self.param_count() - n_moe * (self.num_experts - self.top_k) * per_expert)
