"""Named dense model configurations (the JAX package's ``models/presets.py``
without the MoE presets) and the closed-form parameter count."""

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


PRESETS = {
    "llama-8b": llama_8b,
    "llama-1b": llama_1b,
    "llama-150m": llama_150m,
}


def analytic_param_count(cfg, exclude_embedding=False):
    """Closed-form parameter count. ``exclude_embedding`` drops the token
    embedding (the FLOPs-accounting convention); the untied output
    projection stays."""
    hd = cfg.head_dim
    per_layer = (
        2 * cfg.dim
        + cfg.dim * cfg.n_heads * hd
        + 2 * cfg.dim * cfg.n_kv_heads * hd
        + cfg.n_heads * hd * cfg.dim
        + 3 * cfg.dim * cfg.ffn_hidden_dim
    )
    embed = 0 if exclude_embedding else cfg.vocab_size * cfg.dim
    return embed + cfg.n_layers * per_layer + cfg.dim + cfg.dim * cfg.vocab_size
