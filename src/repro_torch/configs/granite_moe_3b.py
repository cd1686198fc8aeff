"""granite-moe-3b-a800m — fine-grained MoE [hf:ibm-granite/granite-3.0-3b-a800m].

32L, d_model=1536, 24 heads (GQA kv=8, head_dim=64), vocab=49155 (padded to a
multiple of 256 for TP), MoE: 40 experts, top-8, expert d_ff=512.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,  # per-expert
        vocab_size=49155,
        moe=MoEConfig(n_experts=40, top_k=8, expert_d_ff=512),
        tie_embeddings=True,
        microbatch=8,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=64,
        vocab_size=128,
        moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=64),
        tie_embeddings=True,
        attn_chunk=64,
    )
