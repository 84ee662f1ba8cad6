"""Named model configurations (the JAX package's ``models/presets.py``),
dense and Mixture-of-Experts, and the closed-form parameter counts: the
whole model, and the parameters one token touches."""

from pyrecover_tpu_torch.models.llama import ModelConfig


def llama_8b(max_seq_len=2048, vocab_size=131072):
    """The reference's default run: dim 4096, 32 layers, GQA 32/8."""
    return ModelConfig(
        dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        ffn_dim_multiplier=1.3, multiple_of=1024, rope_theta=500000.0,
        vocab_size=vocab_size, max_seq_len=max_seq_len,
    )


def llama_1b(max_seq_len=2048, vocab_size=32768):
    """~1.2B params: dim 2048, 20 layers, GQA 16/8, ffn hidden 7168."""
    return ModelConfig(
        dim=2048, n_layers=20, n_heads=16, n_kv_heads=8,
        ffn_dim_multiplier=1.3, multiple_of=1024, rope_theta=500000.0,
        vocab_size=vocab_size, max_seq_len=max_seq_len,
    )


def llama_150m(max_seq_len=1024, vocab_size=32768):
    """~150M params: dim 768, 12 layers, GQA 12/4."""
    return ModelConfig(
        dim=768, n_layers=12, n_heads=12, n_kv_heads=4,
        ffn_dim_multiplier=1.0, multiple_of=256, rope_theta=500000.0,
        vocab_size=vocab_size, max_seq_len=max_seq_len,
    )


def moe_8x1b(max_seq_len=2048, vocab_size=32768):
    """The llama-1b backbone with 8 top-2 experts a layer: 7.43B params,
    2.15B active a token (`analytic_param_count`,
    `analytic_active_param_count`). Its fp32 train state (params, mu, nu and
    a gradient: ~119 GB) does not fit one 80 GB card."""
    return ModelConfig(
        dim=2048, n_layers=20, n_heads=16, n_kv_heads=8,
        ffn_dim_multiplier=1.3, multiple_of=1024, rope_theta=500000.0,
        vocab_size=vocab_size, max_seq_len=max_seq_len,
        n_experts=8, moe_top_k=2,
    )


def moe_8x150m(max_seq_len=1024, vocab_size=32768):
    """The llama-150m backbone with 8 top-2 experts a layer: 0.52B params,
    0.18B active."""
    return ModelConfig(
        dim=768, n_layers=12, n_heads=12, n_kv_heads=4,
        ffn_dim_multiplier=1.0, multiple_of=256, rope_theta=500000.0,
        vocab_size=vocab_size, max_seq_len=max_seq_len,
        n_experts=8, moe_top_k=2,
    )


def moe_4x1b(max_seq_len=1024, vocab_size=32768):
    """The llama-1b backbone's width (dim 2048, ffn 7168, GQA 16/8) at 8
    layers of 4 top-2 experts: 1,644,267,520 params, 939,624,448 active a
    token. One card trains it with its fp32 master weights and moments."""
    return ModelConfig(
        dim=2048, n_layers=8, n_heads=16, n_kv_heads=8,
        ffn_dim_multiplier=1.3, multiple_of=1024, rope_theta=500000.0,
        vocab_size=vocab_size, max_seq_len=max_seq_len,
        n_experts=4, moe_top_k=2,
    )


PRESETS = {
    "llama-8b": llama_8b,
    "llama-1b": llama_1b,
    "llama-150m": llama_150m,
    "moe-8x1b": moe_8x1b,
    "moe-8x150m": moe_8x150m,
    "moe-4x1b": moe_4x1b,
}


def analytic_param_count(cfg, exclude_embedding=False):
    """Closed-form parameter count. ``exclude_embedding`` drops the token
    embedding (the FLOPs-accounting convention); the untied output
    projection stays. An MoE layer counts its router and every expert."""
    hd = cfg.head_dim
    per_layer = (
        2 * cfg.dim
        + cfg.dim * cfg.n_heads * hd
        + 2 * cfg.dim * cfg.n_kv_heads * hd
        + cfg.n_heads * hd * cfg.dim
    )
    if cfg.n_experts > 0:
        per_layer += cfg.dim * cfg.n_experts  # router
        per_layer += cfg.n_experts * 3 * cfg.dim * cfg.expert_hidden_dim
    else:
        per_layer += 3 * cfg.dim * cfg.ffn_hidden_dim
    embed = 0 if exclude_embedding else cfg.vocab_size * cfg.dim
    return embed + cfg.n_layers * per_layer + cfg.dim + cfg.dim * cfg.vocab_size


def inactive_expert_param_count(cfg):
    """Parameters a token does not touch: the (E - top_k) unused experts'
    FFN weights of every layer; 0 for a dense model. Subtract it before the
    6N FLOPs-a-token model, or MoE MFU is overstated by about E / k."""
    if cfg.n_experts <= 0:
        return 0
    unused = cfg.n_experts - cfg.moe_top_k
    return cfg.n_layers * unused * 3 * cfg.dim * cfg.expert_hidden_dim


def analytic_active_param_count(cfg, exclude_embedding=False):
    """Parameters a token touches (`analytic_param_count` less
    `inactive_expert_param_count`)."""
    return (analytic_param_count(cfg, exclude_embedding=exclude_embedding)
            - inactive_expert_param_count(cfg))
