"""paligemma-3b — SigLIP + Gemma VLM backbone [arXiv:2407.07726].

The assigned entry specifies the TRANSFORMER BACKBONE only (18L gemma-2b,
d_model=2048, 8 heads MQA kv=1, head_dim=256, d_ff=16384, vocab=257216).  The
SigLIP vision tower is a STUB: ``input_specs()`` provides precomputed patch
embeddings (B, 256, d_model) which are concatenated in front of the text
embeddings (prefix-LM style).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        family="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,          # MQA
        head_dim=256,
        d_ff=16384,
        vocab_size=257216,
        frontend="patch",
        n_frontend_tokens=256,  # 224px / 14 patch -> 16x16
        tie_embeddings=True,
        microbatch=8,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="paligemma-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        frontend="patch",
        n_frontend_tokens=16,
        tie_embeddings=True,
        attn_chunk=64,
    )
