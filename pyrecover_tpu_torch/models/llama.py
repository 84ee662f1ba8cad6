"""Llama-3-style decoder-only Transformer, dense or Mixture-of-Experts,
ported from the JAX package's ``models/llama.py``.

The parameters live in ``nn.Module``s (``Transformer`` holding one ``Block``
per layer) with the JAX package's leaf names and layout: every projection is
stored ``(in, out)`` and applied as ``x @ W``. ``params_from_jax`` and
``params_to_numpy`` convert to and from the JAX nested dict of numpy arrays
(``layers/*`` stacked on axis 0), so the two packages' parameter trees map
one to one.

The forward is plain tensor functions over a model, as in the JAX package:
params are stored in ``param_dtype`` (fp32 master weights by default) and
cast to ``compute_dtype`` at each use, RMSNorm runs in fp32 and casts back,
and the vocab projection returns fp32 logits. The JAX package's scan over
stacked layers (``pipeline_blocks`` with no mesh) is a loop over layers
here. With ``remat`` the blocks are rematerialized in the backward
(``torch.utils.checkpoint``, non-reentrant): ``remat_policy="full"``
recomputes each whole block, the flash forward included; ``"save-attn"``
keeps each block's attention output (and the flash residuals q, k, v, lse)
and recomputes only the norm and q/k/v projection before it and the
output projection and FFN after it, so the flash forward runs once.

With ``n_experts`` > 0 each block's FFN is the MoE SwiGLU of
``models/moe.py``: the block holds ``router`` (D, E), kept in fp32 whatever
``param_dtype`` is (routing is discrete: its precision moves picks), and
the stacked experts ``moe_w1``/``moe_w3`` (E, D, F) and ``moe_w2`` (E, F, D)
in place of ``w1``/``w3``/``w2``. Each block also returns its per-row
load-balance aux loss; the forward sums it over the layers and returns its
mean over the rows, under every remat policy (the aux leaves each
checkpointed region as one of its outputs).

On a mesh with an fsdp, tensor or expert axis
(``parallel/sharding.py::shard_model`` hangs a `DeviceMesh` on the model and
each block as ``mesh``) each parameter holds only this rank's box of the JAX
rule. The fsdp axis is FSDP2's: every block and
the model are ``fully_shard``-ed over the fsdp group, so a block's slices
are gathered (in the compute dtype) when it runs, again for its backward
under remat, and their gradients are reduce-scattered. Its hooks fire on a
module's call, so the blocks run as modules (`Block.forward`) and the whole
forward, the loss included, as the model's (`Transformer.forward` with a
``head``). The tensor axis is Megatron's split: ``wq``/``wk``/``wv``/
``w1``/``w3`` by output columns and ``wo``/``w2`` by input rows, so each
rank attends over ``n_heads/tp`` query and ``n_kv_heads/tp`` kv heads,
with one all-reduce after ``wo`` and one after ``w2`` and their conjugates
before the column-split projections (``parallel/collectives.py``; the group
hangs on the model and each block as ``tensor_group``). ``tok_embed`` (its
model dimension over tensor x fsdp) gives each rank its columns of the
tokens' rows, gathered over tensor (`embed_tokens`);
``output``'s vocab-split logits are gathered over tensor. An MoE block's
FFN holds ``E / ep`` experts, each cut on F over tensor, and sums its
partial outputs over expert x tensor (``models/moe.py``); its attention is
the dense block's.

Under a sequence axis each rank holds a chunk of every row's columns and
``attention_impl`` ``ring`` attends over the whole row through the ring
(``ops/ring_attention.py``); RoPE rotates the chunk by its *global*
positions, ``sequence rank x s_local + i`` (`sequence_offset`), which JAX's
GSPMD leaves implicit. Under a pipeline axis the model holds only its
stage's blocks (``shard_model`` keeps them; ``parallel/pipeline.py`` runs
them microbatch by microbatch), while ``tok_embed``, ``final_norm`` and
``output`` stay whole on every stage, as JAX's rules place them.
"""

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pyrecover_tpu_torch.ops.attention import sdpa_attention
from pyrecover_tpu_torch.ops.rope import apply_rope, precompute_rope
from pyrecover_tpu_torch.utils.dtypes import resolve_dtype

_ATTN_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm")
_DENSE_FFN_KEYS = ("w1", "w3", "w2")
_MOE_FFN_KEYS = ("router", "moe_w1", "moe_w3", "moe_w2")


def layer_keys(config):
    """The leaf names of one block: the JAX ``init_params``'s ``layers/*``."""
    return _ATTN_KEYS + (_MOE_FFN_KEYS if config.n_experts > 0 else _DENSE_FFN_KEYS)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model shape (the JAX ``ModelConfig`` without its pipeline and TPU
    tiling fields). Defaults are the reference's 8B run; ``n_experts`` 0 is
    the dense model."""

    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    vocab_size: int = 131072
    ffn_dim_multiplier: float = 1.3
    multiple_of: int = 1024
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    max_seq_len: int = 2048
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attention_impl: str = "sdpa"  # "sdpa" | "flash" | "ring"
    remat: bool = False
    # with remat: "full" recomputes each block; "save-attn" keeps its
    # attention output. "auto" is resolved before the model is built
    # (utils/remat.py); the forward never sees it.
    remat_policy: str = "full"
    # -- mixture of experts (0 experts = dense) --
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01  # load-balance loss scale
    moe_ffn_hidden: int = 0  # per-expert hidden size; 0 -> ffn_hidden_dim
    moe_dispatch: str = "auto"  # "auto" | "grouped" | "scatter" | "einsum" (moe.py)
    # -- pipeline (parallel/pipeline.py; inert without a pipeline axis) --
    pp_microbatches: int = 0  # 0 -> the stage count
    pp_schedule: str = "gpipe"  # "gpipe" | "1f1b"
    pp_virtual_stages: int = 1  # interleaved 1F1B's chunks a stage (1f1b only)

    def __post_init__(self):
        if self.n_experts > 0 and self.moe_top_k > self.n_experts:
            raise ValueError(
                f"moe_top_k={self.moe_top_k} must be <= "
                f"n_experts (--moe-experts) = {self.n_experts}"
            )
        if self.attention_impl not in ("sdpa", "flash", "ring"):
            raise ValueError(
                f"attention_impl={self.attention_impl!r}: expected 'sdpa', 'flash' or 'ring'"
            )
        if self.remat_policy not in ("full", "save-attn", "auto"):
            raise ValueError(f"remat_policy={self.remat_policy!r}: expected 'full', "
                             "'save-attn' or 'auto'")
        if self.pp_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"pp_schedule={self.pp_schedule!r}: expected 'gpipe' or '1f1b'")
        if self.pp_virtual_stages < 1:
            raise ValueError(f"--pp-virtual-stages must be >= 1, got {self.pp_virtual_stages}")
        if self.pp_virtual_stages > 1 and self.pp_schedule != "1f1b":
            raise ValueError("--pp-virtual-stages > 1 requires --pp-schedule 1f1b (the "
                             "interleaved schedule is a 1F1B variant)")

    @property
    def head_dim(self):
        return self.dim // self.n_heads

    @property
    def expert_hidden_dim(self):
        return self.moe_ffn_hidden or self.ffn_hidden_dim

    @property
    def ffn_hidden_dim(self):
        """SwiGLU hidden size: ffn_dim_multiplier * (2/3 * 4 * dim), rounded
        up to a multiple of multiple_of."""
        hidden = int(2 * (4 * self.dim) / 3)
        hidden = int(self.ffn_dim_multiplier * hidden)
        return self.multiple_of * (
            (hidden + self.multiple_of - 1) // self.multiple_of
        )

    def tiny(self, **overrides):
        """A small test-sized variant of this config."""
        base = dict(
            dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=256,
            multiple_of=32, max_seq_len=64,
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


def _param(shape, std, config, device, generator, dtype=None):
    """A parameter in ``dtype`` (default ``param_dtype``): normal(0, std), or
    ones when std is None."""
    pdt = dtype or resolve_dtype(config.param_dtype)
    if std is None:
        return nn.Parameter(torch.ones(shape, dtype=pdt, device=device))
    if device is not None and torch.device(device).type == "meta":
        # no values to draw (and a draw on meta imports torch's symbolic
        # shape machinery, seconds of a process's start)
        return nn.Parameter(torch.empty(shape, dtype=pdt, device=device))
    x = torch.randn(shape, generator=generator, device=device) * std
    return nn.Parameter(x.to(pdt))


class Block(nn.Module):
    """One pre-norm transformer block's parameters (JAX ``layers/*`` leaves
    of one layer)."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        cfg = config
        hd, ffn = cfg.head_dim, cfg.ffn_hidden_dim
        std = 0.02
        resid_std = std / (2 * cfg.n_layers) ** 0.5

        def param(shape, s):
            return _param(shape, s, cfg, device, generator)

        self.attn_norm = param((cfg.dim,), None)
        self.wq = param((cfg.dim, cfg.n_heads * hd), std)
        self.wk = param((cfg.dim, cfg.n_kv_heads * hd), std)
        self.wv = param((cfg.dim, cfg.n_kv_heads * hd), std)
        self.wo = param((cfg.n_heads * hd, cfg.dim), resid_std)
        self.ffn_norm = param((cfg.dim,), None)
        if cfg.n_experts > 0:
            E, F_ = cfg.n_experts, cfg.expert_hidden_dim
            # fp32 whatever param_dtype is: the router's precision moves picks
            self.router = _param((cfg.dim, E), std, cfg, device, generator, torch.float32)
            self.moe_w1 = param((E, cfg.dim, F_), std)
            self.moe_w3 = param((E, cfg.dim, F_), std)
            self.moe_w2 = param((E, F_, cfg.dim), resid_std)
        else:
            self.w1 = param((cfg.dim, ffn), std)
            self.w3 = param((cfg.dim, ffn), std)
            self.w2 = param((ffn, cfg.dim), resid_std)

    def forward(self, x, cos, sin, config, attn_fn, segment_ids=None):
        """The block under ``config``'s remat policy: ``(x, aux)``."""
        return _block_fn(config)(x, self, cos, sin, config, attn_fn, segment_ids)


class Transformer(nn.Module):
    """Token embedding, ``n_layers`` blocks, final norm and an untied output
    projection. Initialised like the JAX ``init_params`` (normal std 0.02,
    residual outputs wo/w2 scaled by 1/sqrt(2 n_layers), norms at one) from
    ``generator``; the draws differ from JAX's, so tests carry weights over
    with ``params_from_jax`` instead."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        self.config = config
        self.tok_embed = _param((config.vocab_size, config.dim), 0.02, config, device, generator)
        self.layers = nn.ModuleList(
            Block(config, device, generator) for _ in range(config.n_layers)
        )
        self.final_norm = _param((config.dim,), None, config, device, generator)
        self.output = _param((config.dim, config.vocab_size), 0.02, config, device, generator)

    def forward(self, tokens=None, segment_ids=None, head=None, stage=None):
        """Logits (batch, seq, vocab) fp32; with ``head``, ``head(hidden,
        aux)`` of `forward_hidden_with_aux`'s outputs instead (the loss,
        computed inside the call, where FSDP2 has the weights gathered).
        With ``stage`` (a pipeline stage's part of a microbatch,
        ``parallel/pipeline.py``), what ``stage()`` returns: run inside this
        module's call, so FSDP2's hooks gather the embedding and the output
        for it and reduce-scatter their gradients after its backward."""
        if stage is not None:
            return stage()
        if head is None:
            return forward(self, tokens, segment_ids)
        return head(*forward_hidden_with_aux(self, tokens, segment_ids))


def rms_norm(x, scale, eps):
    """RMSNorm in fp32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


def _attention_fn(config, mesh=None):
    """The attention the blocks call: flash, the ring over ``mesh``'s
    sequence group (sdpa without one, as JAX's fallback), or sdpa."""
    if config.attention_impl == "flash":
        from pyrecover_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention
    if config.attention_impl == "ring":
        from pyrecover_tpu_torch.ops.ring_attention import ring_attention

        return functools.partial(ring_attention, mesh=mesh)
    return sdpa_attention


def sequence_offset(model, s_local):
    """The global position of this rank's first column: its sequence index
    times the chunk length (0 without a sequence axis)."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return 0
    return mesh.coords.get("sequence", 0) * s_local


def rope_tables(model, tokens):
    """RoPE's (cos, sin) at this rank's global positions."""
    cfg = model.config
    s_local = tokens.shape[1]
    off = sequence_offset(model, s_local)
    cos, sin = precompute_rope(cfg.head_dim, off + s_local, cfg.rope_theta,
                               device=tokens.device)
    return cos[off:], sin[off:]


def _tp_in(h, layer):
    """Before a column-split projection: the backward sums over the tensor
    group."""
    group = getattr(layer, "tensor_group", None)
    if group is None:
        return h
    from pyrecover_tpu_torch.parallel.collectives import tensor_copy

    return tensor_copy(h, group)


def _tp_out(y, layer):
    """After a row-split projection: the partial sums over the tensor
    group."""
    group = getattr(layer, "tensor_group", None)
    if group is None:
        return y
    from pyrecover_tpu_torch.parallel.collectives import tensor_reduce

    return tensor_reduce(y, group)


def qkv_proj(h, layer, config, cos, sin):
    """Project, split into heads and RoPE-rotate q/k; v is only split (this
    rank's heads under a tensor axis)."""
    cfg = config
    cdt = resolve_dtype(cfg.compute_dtype)
    b, s, _ = h.shape
    hd = cfg.head_dim
    h = _tp_in(h, layer)
    q = (h @ layer.wq.to(cdt)).reshape(b, s, -1, hd)
    k = (h @ layer.wk.to(cdt)).reshape(b, s, -1, hd)
    v = (h @ layer.wv.to(cdt)).reshape(b, s, -1, hd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def ffn_sublayer(x, layer, config):
    """Pre-norm FFN sublayer with its residual: dense SwiGLU or MoE. Returns
    ``(x, aux)``; aux (B,) fp32 is the MoE per-row load-balance loss, zeros
    for the dense FFN."""
    cdt = resolve_dtype(config.compute_dtype)
    h = rms_norm(x, layer.ffn_norm, config.norm_eps)
    if config.n_experts > 0:
        from pyrecover_tpu_torch.models.moe import moe_ffn

        # on a mesh its own pair over the expert x tensor group, not this
        # block's tensor pair (which would sum over tensor twice)
        y, aux = moe_ffn(h, layer.router, layer.moe_w1, layer.moe_w3, layer.moe_w2, config,
                         getattr(layer, "mesh", None))
        return x + y, aux
    h = _tp_in(h, layer)
    gate = F.silu(h @ layer.w1.to(cdt))
    up = h @ layer.w3.to(cdt)
    x = x + _tp_out((gate * up) @ layer.w2.to(cdt), layer)
    return x, torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)


def _attend(q, k, v, attn_fn, segment_ids):
    if segment_ids is None:
        return attn_fn(q, k, v, causal=True)
    return attn_fn(q, k, v, causal=True, segment_ids=segment_ids)


def _block_pre(x, layer, cos, sin, config):
    """The block up to attention: RMSNorm and the q/k/v projection."""
    return qkv_proj(rms_norm(x, layer.attn_norm, config.norm_eps), layer, config, cos, sin)


def _block_post(x, attn, layer, config):
    """The block after attention: ``wo`` and its residual, then the FFN."""
    b, s = x.shape[:2]
    cdt = resolve_dtype(config.compute_dtype)
    x = x + _tp_out(attn.reshape(b, s, -1) @ layer.wo.to(cdt), layer)
    return ffn_sublayer(x, layer, config)


def _block(x, layer, cos, sin, config, attn_fn, segment_ids=None):
    """One pre-norm block: attention sublayer, then FFN. Returns ``(x, aux)``."""
    q, k, v = _block_pre(x, layer, cos, sin, config)
    return _block_post(x, _attend(q, k, v, attn_fn, segment_ids), layer, config)


def _block_save_attn(x, layer, cos, sin, config, attn_fn, segment_ids=None):
    """`_block` with the regions before and after attention rematerialized:
    the attention call stays outside them, so its output and its own saved
    tensors are kept and the flash forward is not rerun."""
    q, k, v = checkpoint(_block_pre, x, layer, cos, sin, config, use_reentrant=False)
    attn = _attend(q, k, v, attn_fn, segment_ids)
    return checkpoint(_block_post, x, attn, layer, config, use_reentrant=False)


def _block_fn(config):
    """The block function the forward runs under ``config``'s remat policy."""
    if not config.remat:
        return _block
    if config.remat_policy == "save-attn":
        return _block_save_attn
    if config.remat_policy != "full":
        raise ValueError(f"remat_policy {config.remat_policy!r} must be resolved first")
    return functools.partial(checkpoint, _block, use_reentrant=False)


def forward_hidden_with_aux(model, tokens, segment_ids=None):
    """Embed, run every block, final RMSNorm. Returns ``(hidden, aux)``:
    hidden (batch, seq, dim) before the vocab projection, and the scalar MoE
    aux loss, summed over the layers and averaged over the rows (0 for a
    dense model)."""
    cfg = model.config
    cos, sin = rope_tables(model, tokens)
    attn_fn = _attention_fn(cfg, getattr(model, "mesh", None))
    x = embed_tokens(model, tokens)
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32)
    aux = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for layer in model.layers:
        x, a = layer(x, cos, sin, cfg, attn_fn, segment_ids)
        aux = aux + a
    hidden = rms_norm(x, model.final_norm, cfg.norm_eps)
    return hidden, aux.mean()


def forward_hidden(model, tokens, segment_ids=None):
    return forward_hidden_with_aux(model, tokens, segment_ids)[0]


def embed_tokens(model, tokens):
    """The rows of ``tok_embed`` for ``tokens``, in the compute dtype: under
    a tensor axis each rank looks the tokens up in its columns of the table
    and the rows are gathered over the tensor group (the tokens' rows, not
    the table; each rank keeps its columns' gradient)."""
    rows = model.tok_embed.to(resolve_dtype(model.config.compute_dtype))[tokens]
    group = getattr(model, "tensor_group", None)
    if group is None:
        return rows
    from pyrecover_tpu_torch.parallel.collectives import tensor_gather

    return tensor_gather(rows, -1, group)


def project_vocab(model, hidden):
    """Untied vocab projection with fp32 logits. The JAX package multiplies
    compute-dtype operands into an fp32 result; upcasting both operands
    after the cast to the compute dtype computes the same products. Under a
    tensor axis each rank projects onto its vocab columns and the logits are
    gathered whole."""
    w = model.output.to(resolve_dtype(model.config.compute_dtype))
    group = getattr(model, "tensor_group", None)
    if group is None:
        return hidden.float() @ w.float()
    from pyrecover_tpu_torch.parallel.collectives import tensor_copy, tensor_gather

    return tensor_gather(tensor_copy(hidden, group).float() @ w.float(), -1, group)


def forward(model, tokens, segment_ids=None):
    """tokens (batch, seq) -> logits (batch, seq, vocab) fp32."""
    return project_vocab(model, forward_hidden(model, tokens, segment_ids))


# ======================= JAX parameter tree bridge =======================


def _tensor_of(arr):
    """A numpy array -> a CPU tensor copy. numpy has no bfloat16 of its own
    (JAX hands one over as an extension dtype), so bf16 goes through an
    exact fp32 upcast."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_jax(np_tree):
    """The JAX nested dict of numpy arrays (``layers/*`` stacked on axis 0)
    -> a ``Transformer`` state dict of CPU tensors (copies)."""
    state = {key: _tensor_of(np_tree[key]) for key in ("tok_embed", "final_norm", "output")}
    for key in np_tree["layers"]:
        for i, leaf in enumerate(np.asarray(np_tree["layers"][key])):
            state[f"layers.{i}.{key}"] = _tensor_of(leaf)
    return state


def params_to_numpy(model):
    """A ``Transformer`` -> the JAX nested dict of numpy arrays, layers
    stacked on axis 0 (the inverse of ``params_from_jax``; bf16 leaves come
    out as fp32). A sharded model's slices are gathered whole first: a
    collective every rank of its mesh calls."""

    def np_of(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    if getattr(model, "mesh", None) is not None:
        from pyrecover_tpu_torch.train_state import param_leaves, whole_leaves

        tree = {"layers": {}}
        for leaf in whole_leaves(param_leaves(model)):
            keys = leaf.path[len(".params"):].strip("[]'").split("']['")
            value = np.concatenate([np_of(p).reshape(-1) for p in leaf.parts]).reshape(
                leaf.shape)
            if keys[0] == "layers":
                tree["layers"][keys[1]] = value
            else:
                tree[keys[0]] = value
        return tree

    return {
        "tok_embed": np_of(model.tok_embed),
        "layers": {
            key: np.stack([np_of(getattr(layer, key)) for layer in model.layers])
            for key in layer_keys(model.config)
        },
        "final_norm": np_of(model.final_norm),
        "output": np_of(model.output),
    }
