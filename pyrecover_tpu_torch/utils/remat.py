"""Remat-policy autoscaling (``--remat-policy auto``), ported from the JAX
package's ``utils/remat.py``: spend device-memory headroom on less
recompute.

The policies, from the fastest backward to the leanest memory, and the
first that fits the budget wins:

    none       remat off: every block activation saved, no recompute
    save-attn  remat on, each block's attention output kept: the backward
               recomputes the projections, norms and FFN, not attention
    full       remat on, nothing but the block input kept: the backward
               reruns each whole block, the flash forward included

The byte model is the port's own copy of the single-device rows of the JAX
package's SC05 budget table (``analysis/shardcheck/checks.py::
memory_budget`` over the full train state): parameters and the optimizer
state exactly (``mu``/``nu`` in the parameter dtype, an MoE router in
fp32, the optax counts,
``step``, ``epoch`` and ``rng``), one parameter-sized gradient, saved
activations per layer (6 model widths + 3 FFN widths of (b, s) in the
compute dtype without remat, an MoE layer's FFN width its expert's; 1 model width under ``full``, 2 under
``save-attn``), and fp32 logits plus log-probabilities for one loss chunk.
On a data axis of ``data`` replicas the batch is this rank's rows, and the
mesh terms the port can run are JAX's: under ``--optimizer-sharding zero1``
each moment leaf the data width divides counts 1/data of its bytes (its
``zero1_leaf_spec``), and at ``--grad-allreduce int8`` the state holds this
rank's row of the error-feedback residual (one f32 a padded gradient
element). The fsdp, tensor, sequence and pipeline divisions are not ported.

The capacity is the card's (``torch.cuda.get_device_properties``) unless
``$PYRECOVER_DEVICE_KIND`` names a kind, which wins, as in JAX. With no
known capacity (the CPU, an unknown kind) the policy is ``none`` with
``fits=None``: there is nothing to size against.
"""

import dataclasses
import os

import numpy as np
import torch

from pyrecover_tpu_torch.utils.dtypes import resolve_dtype
from pyrecover_tpu_torch.utils.perf import gpu_memory_bytes

# (policy, ModelConfig.remat, ModelConfig.remat_policy), fastest first
REMAT_POLICIES = (
    ("none", False, "full"),
    ("save-attn", True, "save-attn"),
    ("full", True, "full"),
)

DEVICE_KIND_ENV = "PYRECOVER_DEVICE_KIND"

# batch-suggestion search bound: 8 doublings = 256x the configured batch
_MAX_BATCH_DOUBLINGS = 8
# the train state's scalar leaves: two optax counts, step and epoch (int32)
# and the rng key data (uint32[2])
_COUNTER_BYTES = 4 * 4 + 8


@dataclasses.dataclass(frozen=True)
class RematDecision:
    """The resolved policy and the evidence it was sized on."""

    policy: str  # none | save-attn | full
    remat: bool  # ModelConfig.remat to build with
    remat_policy: str  # ModelConfig.remat_policy to build with
    fits: bool  # None = no budget to judge (unknown capacity)
    device_kind: str
    budget_bytes: int  # None when the capacity is unknown
    hbm_fraction: float
    table: dict  # policy -> modelled total bytes on the device
    batch_size: int
    suggested_batch_size: int  # largest fitting batch, >= configured
    suggested_total_bytes: int


def param_count(cfg):
    """Parameters of the model (embedding, output, norms, blocks); an MoE
    block counts its router and every expert."""
    hd = cfg.head_dim
    per_layer = (2 * cfg.dim + cfg.dim * cfg.n_heads * hd * 2
                 + cfg.dim * cfg.n_kv_heads * hd * 2)
    if cfg.n_experts > 0:
        per_layer += cfg.dim * cfg.n_experts + cfg.n_experts * 3 * cfg.dim * cfg.expert_hidden_dim
    else:
        per_layer += 3 * cfg.dim * cfg.ffn_hidden_dim
    return 2 * cfg.vocab_size * cfg.dim + cfg.dim + cfg.n_layers * per_layer


def param_bytes(cfg):
    """Bytes of the parameters: ``param_dtype`` each, but an MoE router,
    which stays fp32 whatever ``param_dtype`` is."""
    itemsize = resolve_dtype(cfg.param_dtype).itemsize
    router = cfg.n_layers * cfg.dim * cfg.n_experts if cfg.n_experts > 0 else 0
    return param_count(cfg) * itemsize + router * (4 - itemsize)


def leaf_shapes(cfg):
    """``[(key, shape, itemsize)]`` of the model's ``.params`` leaves, layers
    stacked on axis 0 (the JAX tree's leaves)."""
    hd, L, D = cfg.head_dim, cfg.n_layers, cfg.dim
    item = resolve_dtype(cfg.param_dtype).itemsize
    out = [("final_norm", (D,), item)]
    layers = {"attn_norm": (L, D), "ffn_norm": (L, D), "wq": (L, D, cfg.n_heads * hd),
              "wk": (L, D, cfg.n_kv_heads * hd), "wv": (L, D, cfg.n_kv_heads * hd),
              "wo": (L, cfg.n_heads * hd, D)}
    if cfg.n_experts > 0:
        E, F_ = cfg.n_experts, cfg.expert_hidden_dim
        layers.update(router=(L, D, E), moe_w1=(L, E, D, F_), moe_w3=(L, E, D, F_),
                      moe_w2=(L, E, F_, D))
    else:
        F_ = cfg.ffn_hidden_dim
        layers.update(w1=(L, D, F_), w3=(L, D, F_), w2=(L, F_, D))
    out += [(k, layers[k], 4 if k == "router" else item) for k in sorted(layers)]
    return out + [("output", (D, cfg.vocab_size), item), ("tok_embed", (cfg.vocab_size, D), item)]


def optimizer_bytes(cfg, data=1, optimizer_sharding="none", grad_allreduce="fp32",
                    quant_block=256):
    """This rank's optimizer-state bytes: ``mu`` and ``nu`` (1/data of each
    leaf ZeRO-1 shards), the counters, and the int8 residual's row."""
    from pyrecover_tpu_torch.parallel.collectives import padded_flat_len
    from pyrecover_tpu_torch.parallel.sharding import (
        data_dim,
        spec_for_manifest_path,
        zero1_leaf_spec,
    )

    moments = 0
    for key, shape, item in leaf_shapes(cfg):
        nbytes = int(np.prod(shape)) * item
        if optimizer_sharding == "zero1" and data > 1:
            spec = zero1_leaf_spec(spec_for_manifest_path(f"['{key}']", len(shape)), shape,
                                   {"data": data})
            if data_dim(spec) is not None:
                nbytes //= data
        moments += 2 * nbytes
    residual = 0
    if grad_allreduce == "int8":
        n = sum(int(np.prod(shape)) for _, shape, _ in leaf_shapes(cfg))
        residual = 4 * padded_flat_len(n, data, quant_block)
    return moments + _COUNTER_BYTES + residual


def memory_rows(cfg, *, batch_size, seq_len, policy, loss_chunk_size=0, data=1,
                optimizer_sharding="none", grad_allreduce="fp32", quant_block=256):
    """The byte model's rows for one policy (the JAX SC05 table on one
    device of a data axis of ``data``; ``batch_size`` is this rank's rows):
    ``params_bytes``, ``optimizer_bytes``, ``gradients_bytes``,
    ``activations_bytes``, ``logits_bytes`` and their ``total_bytes``."""
    remat, remat_policy = next((r, p) for name, r, p in REMAT_POLICIES if name == policy)
    params = param_bytes(cfg)
    itemsize = resolve_dtype(cfg.compute_dtype).itemsize
    b, s = max(int(batch_size), 1), max(int(seq_len), 1)
    if remat:
        per_layer = b * s * cfg.dim * itemsize * (2 if remat_policy == "save-attn" else 1)
    else:
        ffn = cfg.expert_hidden_dim if cfg.n_experts > 0 else cfg.ffn_hidden_dim
        per_layer = b * s * (6 * cfg.dim + 3 * ffn) * itemsize
    chunk = loss_chunk_size if 0 < loss_chunk_size < s else s
    rows = {
        "params_bytes": params,
        "optimizer_bytes": optimizer_bytes(cfg, data, optimizer_sharding, grad_allreduce,
                                           quant_block),
        "gradients_bytes": params,
        "activations_bytes": per_layer * cfg.n_layers,
        "logits_bytes": 2 * b * chunk * cfg.vocab_size * 4,
    }
    rows["total_bytes"] = sum(rows.values())
    return rows


def modelled_total_bytes(cfg, *, batch_size, seq_len, policy, loss_chunk_size=0, **mesh):
    """Device bytes the model predicts for one policy (``mesh``: `memory_rows`'
    ``data``, ``optimizer_sharding``, ``grad_allreduce``, ``quant_block``)."""
    return memory_rows(cfg, batch_size=batch_size, seq_len=seq_len, policy=policy,
                       loss_chunk_size=loss_chunk_size, **mesh)["total_bytes"]


def device_capacity(device=None):
    """``(device kind, capacity bytes or None)``: ``$PYRECOVER_DEVICE_KIND``
    and its data-sheet memory when set, else the card's name and total
    memory, else ``("", None)``."""
    kind = os.environ.get(DEVICE_KIND_ENV, "")
    if kind:
        return kind, gpu_memory_bytes(kind)
    if device is not None and torch.device(device).type == "cuda":
        props = torch.cuda.get_device_properties(device)
        return props.name, int(props.total_memory)
    return "", None


# Every rank of a data-parallel job runs on the same kind of card and is
# launched with the same $PYRECOVER_DEVICE_KIND, so the resolved policy is
# identical everywhere: what the congruence marker declares.
# distcheck: congruent -- config + the fleet-uniform card and $PYRECOVER_DEVICE_KIND
def resolve_remat_policy(cfg, *, batch_size, seq_len, loss_chunk_size=0, device=None,
                         capacity_bytes=None, hbm_fraction=0.9, data=1,
                         optimizer_sharding="none", grad_allreduce="fp32", quant_block=256):
    """Size ``--remat-policy auto`` against the byte model. Returns a
    `RematDecision`: the first policy, fastest first, whose modelled total
    fits ``hbm_fraction`` of the capacity (``full`` with ``fits=False``
    when none does), and the largest doubling of the batch that policy
    still fits. ``capacity_bytes`` overrides `device_capacity`; ``batch_size``
    is this rank's rows of a data axis of ``data``, whose ZeRO-1 moments and
    int8 residual the model counts."""
    mesh = dict(data=data, optimizer_sharding=optimizer_sharding,
                grad_allreduce=grad_allreduce, quant_block=quant_block)
    kind, capacity = device_capacity(device)
    if capacity_bytes is not None:
        capacity = int(capacity_bytes)
    budget = int(capacity * hbm_fraction) if capacity else None

    def total_at(policy, batch):
        return modelled_total_bytes(cfg, batch_size=batch, seq_len=seq_len, policy=policy,
                                    loss_chunk_size=loss_chunk_size, **mesh)

    table = {policy: total_at(policy, batch_size) for policy, _, _ in REMAT_POLICIES}
    if budget is None:
        chosen, fits = "none", None
        suggested, suggested_bytes = int(batch_size), table["none"]
    else:
        chosen, fits = "full", False
        for policy, _, _ in REMAT_POLICIES:
            if table[policy] <= budget:
                chosen, fits = policy, True
                break
        suggested, suggested_bytes = int(batch_size), table[chosen]
        if fits:
            batch = int(batch_size)
            for _ in range(_MAX_BATCH_DOUBLINGS):
                total = total_at(chosen, batch * 2)
                if total > budget:
                    break
                batch *= 2
                suggested, suggested_bytes = batch, total
    _, remat, remat_policy = next(e for e in REMAT_POLICIES if e[0] == chosen)
    return RematDecision(
        policy=chosen, remat=remat, remat_policy=remat_policy, fits=fits,
        device_kind=kind, budget_bytes=budget, hbm_fraction=hbm_fraction, table=table,
        batch_size=int(batch_size), suggested_batch_size=suggested,
        suggested_total_bytes=suggested_bytes,
    )
