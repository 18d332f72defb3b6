"""ModelConfig: the single dataclass describing every architecture in the zoo.

The port's own copy of `repro.configs.base` (the port imports nothing of the
JAX package).  Each ported architecture has a module
`repro_torch/configs/<id>.py` exporting `CONFIG` (the exact published spec)
and the registry in `repro_torch.configs` maps its name to it.  `reduced()`
derives the smoke-test variant (2 layers, d_model<=256) of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    source: str  # citation: arXiv id / HF model card
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # set in long-context mode
    norm_eps: float = 1e-5

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert ffn dim (fine-grained experts)
    first_dense_layers: int = 0  # deepseek: leading dense layers
    capacity_factor: float = 1.25  # expert-buffer slack (GShard-style dropping)
    # "gather": slot-table formulation — local gathers into expert-sharded
    #           buffers + ONE combine all-reduce per layer (§Perf iteration 4).
    # "scatter": direct scatter/gather on sharded buffers — GSPMD falls back
    #           to select+all-reduce over (S*k, D)-sized tensors (baseline).
    moe_dispatch: str = "gather"

    # SSM (Mamba2)
    ssm_state_dim: int = 0
    ssm_num_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4

    # hybrid (zamba2): one shared attention block invoked every `attn_every`
    # layers with per-site LoRA deltas of rank `hybrid_lora_rank`.
    attn_every: int = 0
    hybrid_lora_rank: int = 0

    # enc-dec (audio): encoder depth; decoder depth = num_layers.
    encoder_layers: int = 0
    # stub modality frontend: length and width of precomputed embeddings
    frontend_len: int = 0  # e.g. audio frames / image patches per sample

    # dtypes
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_decoder_only(self) -> bool:
        return self.family in ("dense", "moe", "ssm", "hybrid", "vlm")

    def param_count(self) -> int:
        """Analytic parameter count N (used for MODEL_FLOPS = 6 N D)."""
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * dh * d
        dense_mlp = 3 * d * self.d_ff
        emb = self.vocab_size * d
        head = d * self.vocab_size
        if self.family in ("dense", "vlm"):
            per_layer = attn + dense_mlp
            n = self.num_layers * per_layer
        elif self.family == "moe":
            expert = 3 * d * self.moe_d_ff
            router = d * self.num_experts
            moe_mlp = (self.num_experts + self.num_shared_experts) * expert + router
            n = self.first_dense_layers * (attn + dense_mlp)
            n += (self.num_layers - self.first_dense_layers) * (attn + moe_mlp)
        elif self.family == "ssm":
            n = self.num_layers * self._ssm_block_params() + self.num_layers * 3 * d * self.d_ff
        elif self.family == "hybrid":
            n_attn_sites = self.num_layers // self.attn_every
            n_mamba = self.num_layers - n_attn_sites
            shared = attn + dense_mlp
            lora = n_attn_sites * self.hybrid_lora_rank * 2 * d * 4
            n = n_mamba * self._ssm_block_params() + shared + lora
        elif self.family == "audio":
            enc = self.encoder_layers * (attn + dense_mlp)
            dec = self.num_layers * (2 * attn + dense_mlp)  # self + cross
            n = enc + dec
        else:
            raise ValueError(self.family)
        return n + emb + head

    def _ssm_block_params(self) -> int:
        d = self.d_model
        d_inner = self.ssm_expand * d
        n = self.ssm_state_dim
        h = self.ssm_num_heads
        # in_proj -> (z, x, B, C, dt) ; conv on x ; out_proj
        return d * (2 * d_inner + 2 * n + h) + d_inner * self.ssm_conv_width + d_inner * d

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed-in experts count)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dh = self.head_dim
        attn = d * dh * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * dh * d
        expert = 3 * d * self.moe_d_ff
        active_mlp = (self.num_experts_per_tok + self.num_shared_experts) * expert
        router = d * self.num_experts
        n = self.first_dense_layers * (attn + 3 * d * self.d_ff)
        n += (self.num_layers - self.first_dense_layers) * (attn + active_mlp + router)
        return n + 2 * self.vocab_size * d

    # ------------------------------------------------------------- variants
    def with_sliding_window(self, window: int = 8192) -> "ModelConfig":
        """Long-context mode for dense-attention families: causal attention
        restricted to the last `window` positions."""
        return dataclasses.replace(self, sliding_window=window)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/wiring, tiny dims."""
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        # keep the GQA grouping property heads % kv == 0
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            num_layers=2,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2)
            if self.num_experts_per_tok
            else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            ssm_state_dim=min(self.ssm_state_dim, 16) if self.ssm_state_dim else 0,
            ssm_num_heads=min(self.ssm_num_heads, 4) if self.ssm_num_heads else 0,
            ssm_head_dim=min(self.ssm_head_dim, 64) if self.ssm_head_dim else 0,
            attn_every=2 if self.attn_every else 0,
            hybrid_lora_rank=min(self.hybrid_lora_rank, 8),
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_len=min(self.frontend_len, 16) if self.frontend_len else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
        )
