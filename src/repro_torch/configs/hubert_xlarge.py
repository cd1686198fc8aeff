"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447].

48L, d_model=1280, 16 heads (kv=16, head_dim=80), d_ff=5120, vocab=504
(masked-prediction codebook).  The CNN waveform frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings (B, S, d_model).
Encoder-only => no decode shapes (DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        causal=False,          # encoder-only
        frontend="frame",
        microbatch=8,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=64,
        causal=False,
        frontend="frame",
        attn_chunk=64,
    )
