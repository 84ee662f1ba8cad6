"""Gradient collectives over the data axis, and the block int8 quantiser
(the JAX package's ``parallel/collectives.py``).

* The bucket layout (``GradBucket``, ``grad_leaf_order``,
  ``compute_bucket_layout``, ``resolve_bucket_layout``,
  ``param_leaf_order``): the JAX step's partition of the gradient leaves
  into fixed-byte buckets in reverse-autodiff order, the loss head first.
  At fp32 the trainer does not run it: ``--grad-bucket-mb`` maps onto
  ``DistributedDataParallel``'s ``bucket_cap_mb``, and DDP forms its own
  buckets (a small first one, then buckets rebuilt in the order the
  gradients arrived), whose all-reduces overlap the backward; at 0 the
  step runs the whole backward under ``no_sync`` and makes one all-reduce
  of the flattened gradients at its end (`sync_grads_once`). Either way
  each gradient is scaled by 1/world, as DDP scales it, and summed over the
  ranks elementwise, so the grouping never changes the arithmetic: fp32
  buckets are bit-equal across layouts, as the JAX docstring promises. On a
  quantized wire the step issues one collective a bucket of this layout.
* ``block_quantize_int8`` / ``block_dequantize_int8``: the serving path's
  int8 KV pool stores keys and values with them at ``block=head_dim``: one
  f32 scale per head per token; the gradient wire at ``--grad-quant-block``.
  Both packages round half to even (``jnp.round``, ``torch.round``) and
  divide by the scale, so ``q`` and the scales agree bit for bit.
* The quantized wire (``--grad-allreduce bf16|int8``): `quantized_psum_flat`
  is the JAX package's two-leg all-reduce on ``torch.distributed``. Leg 1
  moves each rank's quantized chunks with one ``all_to_all`` (int8 payload
  plus f32 scales, or a bf16 payload), the f32 sum of a chunk stays on its
  owner, and leg 2 requantizes that sum and all-gathers it. At int8 it also
  returns the rank's deficit, exactly as JAX defines it, so that
  reduced + Σ_r deficit_r = Σ_r x_r; the step feeds it back next step.
  `quantized_roundtrip_local` is the one-replica form, `padded_flat_len`,
  `flatten_grads` and `wire_bytes_per_element` the JAX helpers. The
  arithmetic is plain PyTorch, as JAX's is XLA and not Pallas.
* The wire's calls are ``all_to_all_single`` and ``all_gather_into_tensor``
  on the payload where it lies: NCCL
  moves CUDA tensors card to card; gloo takes CUDA tensors of int8, bf16
  and f32 too (torch 2.11, two ranks on one card) and stages them through
  host memory itself.
* The tensor axis (``--tp``), as autograd functions the forward calls:
  `tensor_copy` and `tensor_reduce` are Megatron's conjugate pair (identity
  forward with an all-reduce backward before a column-split matmul,
  all-reduce forward with an identity backward after a row-split one);
  `tensor_gather` gathers vocab-split logits and gives each rank back its
  columns' gradient. `sync_model_grads` sums what the backward left partial
  over the batch shards. The fsdp axis's gathers and reduce-scatters are
  FSDP2's (``parallel/sharding.py::shard_model``). The calls are
  ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and ``all_reduce``
  on the named groups of ``parallel/mesh.py``: gloo on the card takes them
  all on CUDA tensors (torch 2.11, two ranks on one card;
  the probe in ``tests/test_torch_fsdp_tp.py``), NCCL across cards.
"""

import dataclasses

import torch
import torch.distributed as dist

GRAD_ALLREDUCE_MODES = ("fp32", "bf16", "int8")
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


# ---- the quantized wire ---------------------------------------------------------


def wire_bytes_per_element(mode, block=DEFAULT_QUANT_BLOCK, elem_bytes=4):
    """Modelled bytes on the wire per gradient element for one leg: a byte
    and one f32 scale per ``block`` at int8, two at bf16, the element's own
    width (``elem_bytes``) at fp32."""
    if mode == "int8":
        return 1.0 + 4.0 / int(block)
    if mode == "bf16":
        return 2.0
    return float(elem_bytes)


def padded_flat_len(param_count, replicas, block=DEFAULT_QUANT_BLOCK):
    """The flattened gradient's length after padding to a multiple of
    ``replicas x block``: per-replica chunks of whole quantization blocks.
    The error-feedback residual has this length too."""
    unit = max(int(replicas), 1) * int(block)
    return -(-int(param_count) // unit) * unit


def flatten_grads(grads, padded_len):
    """Every tensor of ``grads`` (a list, in order) as one f32 vector of
    ``padded_len`` (zero-padded), and ``unflatten(vec)``: the list again, at
    each tensor's shape and dtype."""
    flat = torch.cat([g.to(torch.float32).reshape(-1) for g in grads])
    n = flat.numel()
    if padded_len < n:
        raise ValueError(f"padded_len {padded_len} < flattened gradient size {n}")
    if padded_len > n:
        flat = torch.cat([flat, flat.new_zeros(padded_len - n)])

    layout = [(g.shape, g.dtype, g.numel()) for g in grads]  # not the tensors: they may go

    def unflatten(vec):
        out, off = [], 0
        for shape, dtype, n in layout:
            out.append(vec[off:off + n].reshape(shape).to(dtype))
            off += n
        return out

    return flat, unflatten


def _quantize_leg(x, mode, block):
    """One leg: ``((payload, scales or None), the dequantized view)``."""
    if mode == "int8":
        q, s = block_quantize_int8(x, block)
        return (q, s), block_dequantize_int8(q, s, block)
    q = x.to(torch.bfloat16)  # bf16: the payload is the cast
    return (q, None), q.to(torch.float32)


def all_to_all_rows(x, group=None):
    """``x`` (n, ...) with row j bound for rank j -> (n, ...) with row i from
    rank i."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def all_gather_rows(x, group=None):
    """Every rank's ``x`` stacked on a new first axis, in rank order."""
    n = dist.get_world_size(group)
    out = x.new_empty(n * x.numel())
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)
    return out.reshape(n, *x.shape)


def quantized_psum_flat(x, *, mode, block=DEFAULT_QUANT_BLOCK, group=None):
    """All-reduce this rank's flat f32 partial ``x`` (length a multiple of
    ``world x block``, `padded_flat_len`) over a quantized wire. Returns
    ``(reduced, deficit)``: ``reduced`` the same quantized approximation of
    Σ_r x_r on every rank; ``deficit`` what this rank owes the true sum, its
    leg-1 error over the whole vector plus the leg-2 error of the chunk it
    reduced (None at bf16, the ablation without feedback, and at fp32, one
    exact ``all_reduce``)."""
    if mode == "fp32":
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out, None
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    L = x.shape[0]
    chunk = L // n
    chunks = x.reshape(n, chunk)
    # leg 1 (reduce-scatter): chunk j of every rank to rank j, quantized
    (q1, s1), deq1 = _quantize_leg(chunks, mode, block)
    err1 = (chunks - deq1).reshape(L) if mode == "int8" else None
    del deq1  # the temporaries go as soon as they are spent: they are gradient-sized
    q1_t = all_to_all_rows(q1, group)
    s1_t = all_to_all_rows(s1, group) if s1 is not None else None

    def received(i):
        if s1_t is None:
            return q1_t[i].to(torch.float32)
        return block_dequantize_int8(q1_t[i], s1_t[i], block)

    mine = received(0)
    for i in range(1, n):  # the f32 sum stays local, in rank order
        mine = mine + received(i)
    del q1_t
    # leg 2 (all-gather): the reduced chunk requantized, gathered
    (q2, s2), deq2 = _quantize_leg(mine[None, :], mode, block)
    q2_g = all_gather_rows(q2[0], group)
    if s2 is not None:
        reduced = block_dequantize_int8(
            q2_g.reshape(n, chunk), all_gather_rows(s2[0], group).reshape(n, -1), block
        ).reshape(L)
    else:
        reduced = q2_g.to(torch.float32).reshape(L)
    if mode == "bf16":
        return reduced, None
    # err1 + (zeros with err2 at this rank's chunk), in place: the same sums
    # as JAX's, zero added outside the chunk included
    lo, hi = r * chunk, (r + 1) * chunk
    err1[lo:hi] += mine - deq2[0]
    err1[:lo] += 0.0
    err1[hi:] += 0.0
    return reduced, err1


def quantized_roundtrip_local(x, *, mode, block=DEFAULT_QUANT_BLOCK):
    """`quantized_psum_flat` for one replica: no wire, the same quantize and
    dequantize and the same error-feedback contract (JAX's single-device
    quantized step)."""
    if mode == "fp32":
        return x, None
    _, deq = _quantize_leg(x[None, :], mode, block)
    reduced = deq[0]
    if mode == "bf16":
        return reduced, None
    return reduced, x - reduced


# ---- the tensor axis: Megatron's pair and the logits' gather ---------------------


class _TensorCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _TensorReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _TensorGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.rank, ctx.n = dist.get_rank(group), dist.get_world_size(group)
        return torch.cat(all_gather_rows(x, group).unbind(0), dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, ctx.dim)[ctx.rank].contiguous(), None, None


def tensor_copy(x, group):
    """Identity forward; the backward sums the gradient over the tensor
    group (Megatron's ``f``, before a column-split matmul)."""
    return _TensorCopy.apply(x, group)


def tensor_reduce(x, group):
    """The sum over the tensor group forward; identity backward (Megatron's
    ``g``, after a row-split matmul)."""
    return _TensorReduce.apply(x, group)


def tensor_gather(x, dim, group):
    """Every tensor rank's ``x`` concatenated along ``dim``; the backward
    keeps this rank's piece of the gradient (its peers compute the same
    loss, so nothing is summed)."""
    return _TensorGather.apply(x, dim, group)


def sync_model_grads(params_by_group):
    """Sum what the backward left partial: ``params_by_group`` maps a
    process group (None: the default group) to the parameters whose
    gradients it sums, one flattened ``all_reduce`` a group."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    for group, params in params_by_group:
        grads = [p.grad for p in params]
        if not grads:
            continue
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        for g, synced in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(synced)
