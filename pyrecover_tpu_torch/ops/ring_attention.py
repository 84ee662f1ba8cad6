"""Ring attention over the ``sequence`` group: the JAX package's
``ops/ring_attention.py`` on the hand-written flash kernels.

Each rank of the sequence ring holds one chunk of every row's columns: its
queries, keys and values (and, for packed rows, the chunk's segment ids).
The forward passes the k/v chunks (with their segment ids) around the ring,
``i -> i + 1`` as JAX's ``ppermute``, so at step ``j`` rank ``i`` holds
chunk ``(i - j) mod P``. Each block is exactly flash attention's work and
runs on its kernels (``ops/flash_attention.py``): the diagonal block
causal, an earlier chunk in full (every key precedes every query), a later
one not at all under causality, where JAX masks it to nothing. The keys of
an off-diagonal block carry their own chunk's segment ids (``seg_k``). K1
returns each block's output and its fp32 logsumexp; the blocks merge by
their lse in fp32, ``out = sum_j exp(lse_j - lse) out_j`` with ``lse =
logaddexp_j lse_j``, and the result is cast once, as JAX's fp32
accumulator is. A query row that a block masks whole (another document's
keys) has a block lse of about ``NEG_INF`` there, so its weight is zero.

The backward is a second ring pass, as JAX's custom VJP: each block runs
K2 (dq) and K3 (dk/dv) with the *global* ``out``, ``lse`` and ``dout``, so
the probabilities ``exp(s - lse)`` and ``delta`` are the whole row's. dq
sums locally in fp32; the dk/dv partials travel with their chunk (fp32) and
are home after the full rotation.

``block_kv`` keeps JAX's signature; the kernels run their own compile-time
tiles, so it does not change the result. Without a mesh, or at sequence 1,
the function is the sdpa path, as JAX's fallback is.
"""

import torch

from pyrecover_tpu_torch.ops.attention import sdpa_attention
from pyrecover_tpu_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd

AXIS_SEQ = "sequence"


def _blocks(mesh, causal):
    """``[(step, causal of the block, runs)]`` for this rank: the chunk held
    at ``step`` is ``(i - step) mod P``; under causality the diagonal runs
    causal, earlier chunks in full, and later ones do not run."""
    my, ring = mesh.coords[AXIS_SEQ], mesh.shape[AXIS_SEQ]
    out = []
    for step in range(ring):
        src = (my - step) % ring
        out.append((step, causal and src == my, not causal or src <= my))
    return out


def _merge(acc, lse_acc, out, lse):
    """Fold one block's ``(out, lse)`` into the fp32 running pair."""
    lse_t = lse.transpose(1, 2)[..., None]  # (b, s, hq, 1)
    if acc is None:
        return out.float(), lse
    new = torch.logaddexp(lse_acc, lse)
    new_t = new.transpose(1, 2)[..., None]
    acc = acc * torch.exp(lse_acc.transpose(1, 2)[..., None] - new_t) \
        + out.float() * torch.exp(lse_t - new_t)
    return acc, new


def ring_forward(q, k, v, seg, mesh, causal, scale):
    """The forward ring pass: ``(out in q's dtype, lse (b, hq, s) fp32)``."""
    from pyrecover_tpu_torch.parallel.mesh import ring_shift

    ring = mesh.shape[AXIS_SEQ]
    k_cur, v_cur, s_cur = k, v, seg
    acc = lse = None
    for step, blk_causal, runs in _blocks(mesh, causal):
        if runs:
            o, l = flash_fwd(q, k_cur, v_cur, seg, blk_causal, scale,
                             seg_k=None if seg is None or step == 0 else s_cur)
            acc, lse = _merge(acc, lse, o, l)
        if step < ring - 1:
            moving = [k_cur, v_cur] + ([] if seg is None else [s_cur])
            moved = ring_shift(moving, mesh)
            k_cur, v_cur = moved[:2]
            s_cur = moved[2] if seg is not None else None
    return acc.to(q.dtype).contiguous(), lse.contiguous()


def ring_backward(q, k, v, seg, out, lse, dout, mesh, causal, scale):
    """The backward ring pass: ``(dq, dk, dv)`` in q's and k's dtypes."""
    from pyrecover_tpu_torch.parallel.mesh import ring_shift

    ring = mesh.shape[AXIS_SEQ]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_cur = torch.zeros_like(dk_cur)
    k_cur, v_cur, s_cur = k, v, seg
    for step, blk_causal, runs in _blocks(mesh, causal):
        if runs:
            args = (q, k_cur, v_cur, seg, out, lse, dout, blk_causal, scale)
            seg_k = None if seg is None or step == 0 else s_cur
            dq += flash_bwd_dq(*args, seg_k=seg_k).float()
            dk_b, dv_b = flash_bwd_dkv(*args, seg_k=seg_k)
            dk_cur += dk_b.float()
            dv_cur += dv_b.float()
        # the partials travel every step and are home after the last; the
        # chunks themselves need no last hop
        last = step == ring - 1
        moving = [dk_cur, dv_cur] + ([] if last else [k_cur, v_cur]) + \
            ([] if last or seg is None else [s_cur])
        moved = ring_shift(moving, mesh)
        dk_cur, dv_cur = moved[:2]
        if not last:
            k_cur, v_cur = moved[2:4]
            s_cur = moved[4] if seg is not None else None
    return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype)


class RingAttentionFunction(torch.autograd.Function):
    """JAX's ``_ring_attention_local`` custom VJP: saves (q, k, v, seg, out,
    lse); the backward is the second ring pass."""

    @staticmethod
    def forward(ctx, q, k, v, seg, mesh, causal, scale):
        out, lse = ring_forward(q, k, v, seg, mesh, causal, scale)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.mesh, ctx.causal, ctx.scale = mesh, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_backward(q, k, v, seg, out, lse, dout.contiguous(), ctx.mesh,
                                   ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, *, causal=True, scale=None, mesh=None, block_kv=512,
                   segment_ids=None):
    """Drop-in for ``sdpa_attention`` on this rank's sequence chunk: q (b,
    s_local, hq, d), k/v (b, s_local, hkv, d), ``segment_ids`` (b, s_local)
    -> (b, s_local, hq, d), over ``mesh``'s sequence ring (a `DeviceMesh`).
    Without a mesh, or at sequence 1, the sdpa path (JAX's fallback)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if mesh is None or mesh.shape.get(AXIS_SEQ, 1) == 1:
        return sdpa_attention(q, k, v, causal=causal, scale=scale, segment_ids=segment_ids)
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"n_heads={q.shape[2]} not divisible by n_kv_heads={k.shape[2]}")
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    return RingAttentionFunction.apply(q.contiguous(), k.contiguous(), v.contiguous(), seg,
                                       mesh, bool(causal), float(scale))
