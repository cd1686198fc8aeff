"""deepseek-moe-16b — fine-grained MoE with shared experts [arXiv:2401.06066].

28L, d_model=2048, 16 heads (kv=16, head_dim=128), vocab=102400,
MoE: 64 routed experts top-6 + 2 always-on shared experts, expert d_ff=1408.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,  # per-expert
        vocab_size=102400,
        moe=MoEConfig(
            n_experts=64,
            top_k=6,
            expert_d_ff=1408,
            n_shared_experts=2,
            shared_d_ff=1408,
        ),
        microbatch=8,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=64,
        vocab_size=128,
        moe=MoEConfig(
            n_experts=8, top_k=2, expert_d_ff=64, n_shared_experts=1, shared_d_ff=64
        ),
        attn_chunk=64,
    )
