"""Base model / run configuration for the repro framework.

Every architecture in ``src/repro/configs/`` instantiates :class:`ModelConfig`
(exact published hyper-parameters) plus a ``smoke()`` reduced variant used by
CPU tests. Input shapes live in :mod:`repro_torch.configs.shapes`.

A copy of the reference's ``configs/base.py`` (pure dataclasses, no torch):
the port resolves the same arch ids to the same hyper-parameters.  The
config is frozen, so it is hashable and never mutated by a model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


#: valid ``ModelConfig.attention_backend`` / ``data.attention_backend``
#: values (one source of truth for config, spec validation, and docs)
ATTENTION_BACKENDS = ("auto", "flash", "reference")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (GShard/Switch-style dense dispatch)."""

    n_experts: int
    top_k: int
    expert_d_ff: int
    n_shared_experts: int = 0
    shared_d_ff: int = 0           # d_ff of the always-on shared expert(s)
    capacity_factor: float = 1.25  # per-expert capacity = cf * top_k * S / E
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2
    # dtype of routing one-hots/cumsums/combine: bf16 is integer-exact up to
    # 256 == GROUP, so capacity math stays lossless while the
    # (n,g,G,E,C)-sized intermediates halve — a §Perf memory-term lever.
    route_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) sub-config."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64             # SSD head dim (P)
    chunk: int = 256               # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 (Finch) sub-config."""

    head_size: int = 64
    decay_lora: int = 64           # rank of the data-dependent decay LoRA
    mix_lora: int = 32             # rank of the token-shift mixing LoRA


@dataclass(frozen=True)
class ModelConfig:
    # identity -------------------------------------------------------------
    name: str = "unnamed"
    family: str = "dense"          # dense | moe | ssm | hybrid | audio | vlm

    # transformer core ------------------------------------------------------
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 512
    vocab_size: int = 256
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    causal: bool = True            # False => encoder-only (bidirectional)

    # sliding-window attention (None => full attention)
    swa_window: Optional[int] = None

    # hybrid (zamba2-style): a SHARED attention+MLP block applied every
    # ``attn_every`` backbone layers. 0 => no shared block.
    attn_every: int = 0

    # modality frontend stub: none | patch | frame.  When not "none",
    # input_specs() provides precomputed (B, S_front, d_model) embeddings.
    frontend: str = "none"
    n_frontend_tokens: int = 0     # e.g. image patches for the VLM

    # sub-configs ------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None

    # attention backend -----------------------------------------------------
    #: "auto" | "flash" | "reference".  "flash" routes full-sequence
    #: attention through the kernel layer (repro_torch.kernels.ops.attention:
    #: the CUDA flash kernel on the card, the blocked-streaming torch path
    #: elsewhere — causally clipped K/V, no (S, T) logits materialized).
    #: "reference" keeps the naive chunked softmax path (the bitwise
    #: parity oracle).  "auto" resolves by availability at trace time
    #: (models/attention.resolve_attention_backend): flash wherever the
    #: TP contract allows (tp == 1), reference otherwise.
    attention_backend: str = "auto"

    # training --------------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    microbatch: int = 0            # 0 => no gradient accumulation
    fsdp: bool = True              # shard weights and optimizer state over the data axis
    scan_layers: bool = True
    attn_chunk: int = 1024         # query-chunk for memory-safe attention
    # Unroll inner seq-chunk scans (attention/WKV/SSD/loss). Used by the
    # roofline's per-layer costing so cost_analysis sees every chunk
    # (XLA counts while-loop bodies once).  Off for real compiles.
    unroll_scans: bool = False

    # capability flags -------------------------------------------------------
    @property
    def is_decoder(self) -> bool:
        return self.causal

    @property
    def sub_quadratic(self) -> bool:
        """True iff decode state does not grow quadratically with context and
        per-token decode cost/caches stay bounded (SSM / SWA / hybrid)."""
        return (
            self.family in ("ssm", "hybrid")
            or self.swa_window is not None
            or self.rwkv is not None
        )

    # ---- TP-padding helpers (model axis of size ``tp``) ---------------------
    def padded_heads(self, tp: int) -> int:
        """Query heads padded so they divide the tensor-parallel axis."""
        return _round_up(self.n_heads, tp) if tp > 1 else self.n_heads

    def kv_sharded(self, tp: int) -> bool:
        """KV heads are shardable over the model axis iff divisible."""
        return tp > 1 and self.n_kv_heads % tp == 0

    def padded_vocab(self, tp: int) -> int:
        return _round_up(self.vocab_size, 256 if tp > 1 else 1)

    # ---- misc ---------------------------------------------------------------
    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytical parameter count (true, un-padded config)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d
        if self.frontend != "none":
            emb += d * d  # frontend adapter stub projection
        per_layer = 0
        if self.family in ("dense", "vlm", "audio"):
            per_layer = self._attn_params() + self._dense_ffn_params() + 2 * d
        elif self.family == "moe":
            m = self.moe
            routed = m.n_experts * 3 * d * m.expert_d_ff
            shared = m.n_shared_experts * 3 * d * (m.shared_d_ff or m.expert_d_ff)
            router = d * m.n_experts
            per_layer = self._attn_params() + routed + shared + router + 2 * d
        elif self.family == "ssm":
            r = self.rwkv
            H = d // r.head_size
            tmix = 4 * d * d + d * d  # r,k,v,g projections + output
            tmix += 2 * d * r.decay_lora + 6 * d * r.mix_lora  # LoRAs
            tmix += H * r.head_size  # per-head `u` bonus
            cmix = 2 * d * self.d_ff  # rwkv channel-mix has 2 mats (k,v)
            per_layer = tmix + cmix + 2 * d
        elif self.family == "hybrid":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            mamba = (
                d * (2 * di + 2 * s.d_state * (di // s.head_dim) + nh) // 1
                + di * d          # out proj
                + s.d_conv * (di + 2 * s.d_state * nh) // 1
                + nh              # A_log, D
            )
            # simpler faithful estimate: in_proj (d -> 2*di + 2*n_groups*d_state + nh)
            zxbcdt = 2 * di + 2 * s.d_state + nh
            mamba = d * zxbcdt + di * d + s.d_conv * di + 2 * nh
            per_layer = mamba + 2 * d
        total = emb + L * per_layer
        if self.attn_every:
            total += self._attn_params() + self._dense_ffn_params() + 2 * self.d_model
        if not self.tie_embeddings:
            total += self.vocab_size * d
        return total

    def _attn_params(self) -> int:
        d = self.d_model
        q = d * self.n_heads * self.head_dim
        kv = 2 * d * self.n_kv_heads * self.head_dim
        o = self.n_heads * self.head_dim * d
        b = (self.n_heads + 2 * self.n_kv_heads) * self.head_dim if self.qkv_bias else 0
        return q + kv + o + b

    def _dense_ffn_params(self) -> int:
        # gated (SwiGLU-style) FFN: w_in, w_gate, w_out
        return 3 * self.d_model * self.d_ff

    def active_param_count(self) -> int:
        """Active parameters per token (MoE counts only routed top-k)."""
        if self.family != "moe":
            return self.param_count()
        d, L, m = self.d_model, self.n_layers, self.moe
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        routed = m.top_k * 3 * d * m.expert_d_ff
        shared = m.n_shared_experts * 3 * d * (m.shared_d_ff or m.expert_d_ff)
        per_layer = self._attn_params() + routed + shared + d * m.n_experts + 2 * d
        return emb + L * per_layer


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer / schedule / fault-tolerance knobs for the training entry point."""

    lr: float = 3e-4
    weight_decay: float = 0.1
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    seed: int = 0

    # FedAT-at-scale knobs (cross-tier / cross-pod behaviour)
    fedat_enabled: bool = False
    fedat_sync_every: int = 1      # cross-tier aggregation cadence (steps)
    fedat_lambda: float = 0.4      # proximal constraint (paper lambda)
    fedat_compress_bits: int = 0   # 0 => fp32 cross-tier sync; 8/16 => quantized

    # checkpointing / fault tolerance
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 50
    keep_ckpts: int = 3
