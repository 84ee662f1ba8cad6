"""Gradient collectives over the data axis, and the block int8 quantiser
(the JAX package's ``parallel/collectives.py``).

* The fp32 bucket layout (``GradBucket``, ``grad_leaf_order``,
  ``compute_bucket_layout``, ``resolve_bucket_layout``,
  ``param_leaf_order``): the JAX step's partition of the gradient leaves
  into fixed-byte buckets in reverse-autodiff order, the loss head first.
  The trainer does not run it: ``--grad-bucket-mb`` maps onto
  ``DistributedDataParallel``'s ``bucket_cap_mb``, and DDP forms its own
  buckets (a small first one, then buckets rebuilt in the order the
  gradients arrived), whose all-reduces overlap the backward; at 0 the
  step runs the whole backward under ``no_sync`` and makes one all-reduce
  of the flattened gradients at its end (`sync_grads_once`). Either way
  each gradient is scaled by 1/world, as DDP scales it, and summed over the
  ranks elementwise, so the grouping never changes the arithmetic: fp32
  buckets are bit-equal across layouts, as the JAX docstring promises.
* ``block_quantize_int8`` / ``block_dequantize_int8``: the serving path's
  int8 KV pool stores keys and values with them at ``block=head_dim``: one
  f32 scale per head per token. Both packages round half to even
  (``jnp.round``, ``torch.round``) and divide by the scale, so ``q`` and
  the scales agree bit for bit.

The quantized wire formats (``--grad-allreduce bf16|int8`` with error
feedback) are not ported (ROADMAP Queue 1).
"""

import dataclasses

import torch
import torch.distributed as dist

DEFAULT_QUANT_BLOCK = 256
INT8_MAX = 127.0


def block_quantize_int8(x, block=DEFAULT_QUANT_BLOCK):
    """``x`` (..., L) with ``L % block == 0`` -> ``(q int8 of x.shape,
    scales f32 of (..., L // block))``. All-zero blocks get scale 1, so they
    dequantize exactly (0 / 1 -> 0)."""
    shape = x.shape
    blocks = x.reshape(*shape[:-1], shape[-1] // block, block)
    absmax = blocks.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / INT8_MAX, 1.0).to(torch.float32)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8).reshape(shape), scale


def block_dequantize_int8(q, scale, block=DEFAULT_QUANT_BLOCK):
    """The inverse of `block_quantize_int8`, in f32."""
    shape = q.shape
    blocks = q.to(torch.float32).reshape(*shape[:-1], shape[-1] // block, block)
    return (blocks * scale[..., None].to(torch.float32)).reshape(shape)


# ---- the fp32 bucket layout ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GradBucket:
    """One fixed-byte bucket of gradient leaves: ``leaf_lo:leaf_hi`` of the
    issue-ordered leaf list (`grad_leaf_order`; bucket 0 holds the loss
    head, whose gradients are ready first), its element count, its length
    padded to ``replicas x block``, and its offset in the issue-ordered
    concatenation."""

    index: int
    leaf_lo: int
    leaf_hi: int
    n_elems: int
    padded_len: int
    offset: int

    @property
    def nbytes_f32(self):
        return 4 * self.n_elems


# forward stage of each top-level parameter key: the backward finishes the
# gradients in roughly reverse forward order (loss head first, the token
# embedding last). Unknown keys rank with the layer stack.
_FORWARD_STAGE = {"tok_embed": 0, "layers": 1, "final_norm": 2, "output": 3}


def grad_leaf_order(first_keys):
    """Reverse-autodiff issue order over gradient leaves, given each leaf's
    top-level key in the JAX tree-flatten order: the loss head first, the
    layer stack next, the embedding last; ties keep reversed flatten
    order. Returns a permutation of leaf indices."""
    first_keys = list(first_keys)
    return sorted(range(len(first_keys)),
                  key=lambda i: (_FORWARD_STAGE.get(first_keys[i], 1), i), reverse=True)


def compute_bucket_layout(leaf_sizes, bucket_bytes, replicas=1, block=DEFAULT_QUANT_BLOCK,
                          order=None):
    """Partition the leaves (element counts, in flatten order) into buckets
    of at most ``bucket_bytes`` fp32 bytes, walking ``order`` (default:
    reversed flatten order) and packing consecutive leaves greedily. A
    leaf above the cap is a bucket of its own; leaves are never split."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    sizes_all = [int(n) for n in leaf_sizes]
    if order is None:
        order = list(range(len(sizes_all)))[::-1]
    sizes = [sizes_all[j] for j in order]
    unit = max(int(replicas), 1) * int(block)
    buckets, lo, cur, offset = [], 0, 0, 0

    def close(hi):
        nonlocal lo, cur, offset
        n = sum(sizes[lo:hi])
        buckets.append(GradBucket(index=len(buckets), leaf_lo=lo, leaf_hi=hi, n_elems=n,
                                  padded_len=-(-n // unit) * unit, offset=offset))
        offset += n
        lo, cur = hi, 0

    for i, n in enumerate(sizes):
        if cur and (cur + n) * 4 > bucket_bytes:
            close(i)
        cur += n
        if cur * 4 > bucket_bytes:
            close(i + 1)
    if cur or lo < len(sizes):
        close(len(sizes))
    return buckets


def resolve_bucket_layout(leaf_sizes, bucket_mb, replicas=1, block=DEFAULT_QUANT_BLOCK,
                          order=None):
    """The layout for a ``--grad-bucket-mb`` setting, or None when
    bucketing is off (``bucket_mb <= 0``) or one bucket would hold every
    leaf (the unbucketed form)."""
    if not bucket_mb or bucket_mb <= 0:
        return None
    layout = compute_bucket_layout(leaf_sizes, int(bucket_mb * 2**20), replicas, block,
                                   order=order)
    return layout if len(layout) > 1 else None


def param_leaf_order(model):
    """`grad_leaf_order` over the model's JAX ``.params`` leaves."""
    from pyrecover_tpu_torch.train_state import param_leaves

    return grad_leaf_order([leaf.path.split("'")[1] for leaf in param_leaves(model)])


# ---- data-parallel gradient sync ------------------------------------------------


def data_parallel(module, grad_bucket_mb, device):
    """``module`` under ``DistributedDataParallel`` with
    ``--grad-bucket-mb``'s buckets (any cap when it is 0: the step then
    syncs once, after the backward, with `sync_grads_once`). Every
    parameter is used and the module holds no buffers."""
    from torch.nn.parallel import DistributedDataParallel

    return DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None,
        bucket_cap_mb=grad_bucket_mb if grad_bucket_mb > 0 else 25,
        find_unused_parameters=False,
    )


def sync_grads_once(params, world):
    """One all-reduce of every parameter's gradient, flattened: each scaled
    by 1/world (as DDP scales a bucket) and summed over the ranks, written
    back in place."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    grads = [p.grad for p in params]
    flat = _flatten_dense_tensors(grads)
    flat.mul_(1.0 / world)
    dist.all_reduce(flat)
    for g, synced in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(synced)
