"""Mixture-of-Experts SwiGLU FFN, on one device or sharded over the expert
and tensor axes, ported from the JAX package's ``models/moe.py``.

Routing is the JAX package's: an fp32 softmax router, top-k picks whose
gates are renormalised to sum to one (Mixtral-style), and a per-row expert
capacity ``C`` filled first come, first served in ``(s, k)`` flat pick
order: a pick's queue position (``rank``) is an exclusive cumsum over the
``(B, S·K, E)`` one-hot of its expert. Picks at ``rank >= C`` are dropped:
they contribute nothing to the output and their gate is zeroed, but they
still count in the Switch load-balance aux loss ``E · Σ_e f_e·p_e`` per
row. Every backend shares `_route`, so their equality is structural.

Ties among the router's probabilities (a zero router makes every row a tie)
go to the lower expert index, as ``jax.lax.top_k`` breaks them: the picks
come from a stable descending sort. The logits are computed in fp32 from
fp32 casts of both operands; nothing on this path enables TF32.

Three dispatch backends compute the same function:

* ``grouped`` (`_moe_ffn_grouped`): every ``(token, pick)`` of the batch in
  one pool, stably sorted by expert, and the three expert projections as
  grouped matrix products over contiguous expert groups
  (``torch._grouped_mm`` with device-side offsets, so no group size is read
  back to the host). Dropped picks stay in their group as zero rows, which
  SwiGLU maps to zero. The JAX package's ``jax.lax.ragged_dot`` form.
* ``scatter`` (`_moe_ffn_impl`): a static ``(B, E, C, D)`` slot tensor,
  batched products over experts, and a gather of each pick's slot.
* ``einsum`` (`_moe_ffn_einsum`): the Switch-style one-hot
  ``(B, S, K, E, C)`` dispatch and combine tensors and einsums only.

``auto`` picks ``grouped``, as the JAX package's ``moe_ffn`` does at ep 1
on an unsharded batch. Under data parallelism each rank holds only its own
rows, where JAX's ``auto`` picks ``_moe_ffn_grouped_ep`` at ep 1: the same
flat sort, kept local to the shard. Over a rank's local rows that is
exactly ``grouped``, so the port runs ``grouped`` there too. At fp32
compute ``auto`` picks ``scatter`` instead: fp32 ``torch._grouped_mm`` on
the card reads its group offsets back to the host, a synchronizing call
that ``--transfer-guard disallow`` refuses, and ``scatter`` computes the
same function with nothing read back. Its slots are about cf × the picks,
so at the no-drop capacity of decode and paged serving (cf = E) it runs E×
``grouped``'s expert products; on the H100 that costs up to 1.6× on a long
fp32 prefill and about nothing on decode, where ``grouped``'s read-back
stalls the host instead (``PERF.md``). At ep > 1 ``auto`` follows JAX's
slot-size rule: ``einsum`` while the rank's ``(B, S, K, E, C)`` slot tensor
holds at most 64 Mi elements, else ``scatter`` (``scatter`` at fp32, as
above).

On a mesh with an fsdp, tensor or expert axis (``parallel/sharding.py::
shard_model`` hangs the `DeviceMesh` on each block) a block's expert
weights are this rank's ``E / ep`` experts, ``[e0, e0 + E/ep)`` with ``e0 =
expert index · E/ep``, each cut on F over tensor (FSDP2 gathers the fsdp
slices of D before the block runs). Batch rows are split over data x fsdp
only, so expert and tensor peers hold the same rows. Every rank routes its
rows over all E experts, keeps the picks of its local experts, runs them,
combines with gate weight 0 for the others, and one fp32 all-reduce over
the ``expert_tensor`` group sums the partial outputs: the combine exchange
and the row-parallel ``w2`` reduction at once (JAX's
`_moe_ffn_grouped_ep`, and `_moe_ffn_sharded` for ``scatter`` and
``einsum``). JAX leaves ``scatter``'s and ``einsum``'s exchange to XLA's
all-to-alls over the expert axis; since expert peers hold the same rows,
the local slots and the same one sum compute the same function without an
exchange. The input ``h`` and the router weight enter that path through
``parallel/collectives.py::tensor_copy`` (identity forward, a sum over the
group backward: each rank's gradient covers its local picks only), the
output leaves it through ``tensor_reduce`` (the sum forward, identity
backward), and the aux loss comes from a second routing pass on the
un-copied values, so its gradient counts once, not ep·tp times. A block's
MoE never runs the tensor pair of the dense FFN as well, which would sum
over tensor twice.

Under a sequence axis a rank holds a chunk of every row's columns, and
each row is still routed whole, as JAX routes it (GSPMD sees the whole
row): the capacity is the whole row's, a pick's first-come position
continues from the picks of its expert in the earlier chunks (an exclusive
prefix of the chunks' counts over the ``sequence`` group, in rank order),
and the Switch aux is the row's, from the whole row's counts and mean
probabilities (the probabilities summed by an all-reduce whose backward is
the identity, so each rank's gradient covers its own columns and the sum
over the group's gradients is the row's). ``auto`` there takes JAX's
slot-size rule, never the grouped forms, whose sort is over whole rows; an
explicit ``grouped`` computes the same function over the chunk and warns
once a process, as JAX's does. Inside a pipeline stage the dispatch is
``einsum`` whatever was asked (JAX's rule for its manual regions).

Every row movement (a pick into the sorted pool, a pick into its slot, a
slot back to its pick) is one ``_PairedGather``: a gather forward whose
backward is the gather of the inverse map, never an index-add. The maps are
partial bijections, so the backward is exact, and it is deterministic on
the card without atomics.
"""

import math

import torch
import torch.nn.functional as F


def moe_capacity(seq_len, n_experts, top_k, capacity_factor):
    """Per-row expert capacity: ceil(S·k·cf / E), at least 1."""
    return max(1, int(math.ceil(seq_len * top_k * capacity_factor / n_experts)))


def _top_k(probs, K):
    """Each token's K picks, highest first, (B, S, K): a stable descending
    sort keeps equal probabilities in index order."""
    return torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices[..., :K]


def _seq_ctx(mesh):
    """``(group, index, count)`` of ``mesh``'s sequence axis, where it splits
    every row's columns (None: rows are whole on each rank)."""
    if mesh is None or int(mesh.shape.get("sequence", 1)) == 1:
        return None
    return mesh.group("sequence"), int(mesh.coords["sequence"]), int(mesh.shape["sequence"])


def _row_len(S, seq):
    """A whole row's length from a rank's ``S`` columns."""
    return S * (seq[2] if seq is not None else 1)


def _picks(h, router_w, E, K):
    """A rank's routing picks: ``(probs, eids, gvals, onehot)``, probs (B,
    S, E) fp32; eids, gvals (B, N) with N = S·K in (s, k) flat order, the
    gates renormalised over each token's K picks; onehot (B, N, E) int32."""
    B, S, _ = h.shape
    N = S * K
    logits = h.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    idx = _top_k(probs, K)
    gate_vals = probs.gather(-1, idx)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    eids = idx.reshape(B, N)
    gvals = gate_vals.reshape(B, N)
    onehot = (eids[..., None] == torch.arange(E, device=h.device)).to(torch.int32)
    return probs, eids, gvals, onehot


def _route(h, router_w, E, K, C, seq=None):
    """The routing every backend shares. Returns ``(probs, eids, gvals,
    onehot, rank, valid, base, counts)``: `_picks`' four; rank, valid (B,
    N); base (B, E), each expert's picks on the row before this rank's
    columns; counts (B, E), each expert's picks on the whole row. Under a
    sequence axis (``seq``, `_seq_ctx`) the row is routed whole, as JAX
    routes it: a pick's queue position continues from the picks of its
    expert in the earlier chunks (the exclusive prefix of the chunks'
    counts in rank order, one all-gather), and ``C`` is the whole row's
    capacity."""
    B = h.shape[0]
    probs, eids, gvals, onehot = _picks(h, router_w, E, K)
    # queue position within the pick's expert: an exclusive cumsum over the
    # one-hot, first come first served (integer sums: exact and deterministic)
    prio = torch.cumsum(onehot, dim=1) - onehot
    counts = onehot.sum(dim=1).to(torch.int32)
    base = torch.zeros((B, E), dtype=torch.int32, device=h.device)
    if seq is not None:
        from pyrecover_tpu_torch.parallel.collectives import all_gather_rows

        group, index, _ = seq
        chunks = all_gather_rows(counts.contiguous(), group)
        base = chunks[:index].sum(dim=0).to(torch.int32)
        counts = chunks.sum(dim=0).to(torch.int32)
        prio = prio + base[:, None, :]
    rank = (prio * onehot).sum(dim=-1)
    valid = rank < C
    return probs, eids, gvals, onehot, rank, valid, base, counts


def _switch_aux(probs, counts, E, N, seq=None):
    """Switch load-balance loss per row, (B,) fp32: E · Σ_e f_e·p_e with f_e
    the pre-capacity share of picks routed to e (``counts`` (B, E), the
    row's picks of each expert; ``N`` a rank's picks a row) and p_e the mean
    router probability. A uniform router gives 1. Under a sequence axis
    both run over the whole row: ``counts`` is the row's already, and the
    probabilities are summed by an all-reduce whose backward is the
    identity (each rank's gradient then covers its own columns, and the sum
    of the ranks' gradients is the row's), so every rank holds the row's
    aux."""
    counts = counts.float()
    if seq is None:
        return E * (counts / N * probs.mean(dim=1)).sum(dim=-1)
    from pyrecover_tpu_torch.parallel.collectives import tensor_reduce

    group, _, sp = seq
    p_e = tensor_reduce(probs.sum(dim=1), group) / (probs.shape[1] * sp)
    return E * (counts / (N * sp) * p_e).sum(dim=-1)


def _gather_rows(x, idx, keep):
    """``out[b, j] = x[b, idx[b, j]]``, zeroed where ``keep`` is false (None:
    nothing is zeroed). x (B, R, D), idx and keep (B, J)."""
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return out if keep is None else out * keep[..., None].to(out.dtype)


class _PairedGather(torch.autograd.Function):
    """`_gather_rows` of ``x`` through ``(idx, keep)``, whose backward is
    `_gather_rows` of the gradient through the inverse map ``(inv,
    inv_keep)``: every kept output row reads one input row and every input
    row reaches at most one kept output row, so the gradient of input row
    ``i`` is the gradient of output row ``inv[i]`` where ``inv_keep[i]``,
    else zero."""

    @staticmethod
    def forward(ctx, x, idx, keep, inv, inv_keep):
        ctx.save_for_backward(inv, inv_keep)
        return _gather_rows(x, idx, keep)

    @staticmethod
    def backward(ctx, grad):
        inv, inv_keep = ctx.saved_tensors
        return _gather_rows(grad.contiguous(), inv, inv_keep), None, None, None, None


def _paired_gather(x, idx, keep, inv, inv_keep):
    return _PairedGather.apply(x, idx, keep, inv, inv_keep)


def _swiglu_grouped(x, w1, w3, w2, offs):
    """The expert SwiGLU over the expert-sorted rows ``x`` (M, D), group e
    ending at ``offs[e]``."""
    gate = F.silu(torch._grouped_mm(x, w1, offs=offs))
    up = torch._grouped_mm(x, w3, offs=offs)
    return torch._grouped_mm(gate * up, w2, offs=offs)


def _flat_pick_sort(h, ids_flat, keep_flat, K):
    """The grouped backend's dispatch: the (rows·S·K, D) pool of every
    (token, pick) of ``h`` (rows, S, D) in flat pick order, stably sorted by
    ``ids_flat``, rows whose ``keep_flat`` is off zeroed. Returns ``(x,
    order, inv)``: the sorted pool, the sort permutation and its inverse."""
    rows, S, D = h.shape
    picks = h[:, :, None].expand(rows, S, K, D).reshape(1, rows * S * K, D)
    order = torch.argsort(ids_flat, stable=True)
    inv = torch.argsort(order)
    x = _paired_gather(picks, order[None], keep_flat[order][None], inv[None], keep_flat[None])
    return x[0], order, inv


def _flat_pick_combine(out, order, inv, wgt, rows, S, K):
    """The grouped backend's combine: the expert-sorted outputs (M, D) back
    in flat pick order, weighted by each pick's gate (zero for dropped
    picks) and summed over the K picks of each token."""
    D = out.shape[-1]
    y_picks = _paired_gather(out[None], inv[None], None, order[None], None)[0]
    return (y_picks.reshape(rows, S, K, D) * wgt.reshape(rows, S, K, 1)).sum(dim=2)


def _moe_ffn_grouped(h, router_w, w1, w3, w2, config, experts=None, seq=None, aux=True):
    """Grouped dispatch: the batch's picks sorted by expert through grouped
    matrix products (the JAX package's ``_moe_ffn_grouped``). The group
    sizes are the pre-capacity routing histogram, one-hot sums on the
    device: overflow picks stay in their group as zero rows, so the groups
    cover the whole pool. ``experts`` must be every expert (None, or ``(0,
    E)``); ``seq`` as `_route`'s. With ``aux`` false the aux is not
    computed (None): the caller takes it elsewhere."""
    B, S, D = h.shape
    E, K = config.n_experts, config.moe_top_k
    if experts not in (None, (0, E)):
        raise ValueError(f"the grouped backend runs every expert, not {experts}")
    C = moe_capacity(_row_len(S, seq), E, K, config.moe_capacity_factor)
    N = S * K
    probs, eids, gvals, onehot, rank, valid, _, counts = _route(h, router_w, E, K, C, seq)
    cdt = h.dtype
    x, order, inv = _flat_pick_sort(h, eids.reshape(-1), valid.reshape(-1), K)
    offs = torch.cumsum(onehot.sum(dim=(0, 1)), dim=0).to(torch.int32)
    out = _swiglu_grouped(x, w1.to(cdt), w3.to(cdt), w2.to(cdt), offs)
    w = torch.where(valid, gvals, 0.0).to(cdt)
    y = _flat_pick_combine(out, order, inv, w, B, S, K)
    return y.to(h.dtype), _switch_aux(probs, counts, E, N, seq) if aux else None


def _slot_maps(eids, rank, onehot, E, C, base):
    """The scatter backend's two maps between picks and the (E·C) slots of
    each row: ``slot`` (B, N), each pick's slot (clamped for dropped picks),
    and ``src``/``filled`` (B, E·C), the pick each slot holds and whether it
    holds one. The picks of expert e, in a stable sort by expert, come in
    pick order, so the c-th of them is the one of rank ``base_e + c``
    (``base`` (B, E): the row's picks of e in earlier sequence chunks): slot
    (e, c) holds pick ``order[start_e + c - base_e]`` when ``base_e <= c <
    base_e + count_e``; the other slots hold another chunk's picks, or
    none."""
    B, N = eids.shape
    slot = (eids * C + rank).clamp(0, E * C - 1)
    order = torch.argsort(eids, dim=1, stable=True)
    counts = onehot.sum(dim=1)  # (B, E)
    starts = torch.cumsum(counts, dim=1) - counts
    c = torch.arange(C, device=eids.device) - base[:, :, None]  # (B, E, C)
    at = (starts[:, :, None] + c).clamp(min=0).reshape(B, E * C)
    filled = ((c >= 0) & (c < counts[:, :, None])).reshape(B, E * C)
    src = torch.gather(order, 1, at.clamp(max=N - 1))
    return slot, src, filled


def _moe_ffn_impl(h, router_w, w1, w3, w2, config, experts=None, seq=None, aux=True):
    """Rank-and-scatter dispatch (the JAX package's ``_moe_ffn_impl``): a
    static (B, E, C, D) slot tensor. Each slot is gathered from the pick that
    fills it (in-capacity slots are unique; empty slots are zero), the
    expert SwiGLU runs at fixed capacity, and each pick gathers its slot
    back, weighted by its gate. ``experts`` ``(e0, n)``: the weights hold
    experts ``[e0, e0 + n)`` only, and y is those experts' share; ``seq`` as
    `_route`'s; ``aux`` as `_moe_ffn_grouped`'s."""
    B, S, D = h.shape
    E, K = config.n_experts, config.moe_top_k
    C = moe_capacity(_row_len(S, seq), E, K, config.moe_capacity_factor)
    N = S * K
    e0, n_loc = experts or (0, E)
    probs, eids, gvals, onehot, rank, valid, base, counts = _route(h, router_w, E, K, C, seq)
    slot, src, filled = _slot_maps(eids, rank, onehot, E, C, base)
    if n_loc != E:  # this rank's experts' slots, and the picks that fill them
        valid = valid & (eids >= e0) & (eids < e0 + n_loc)
        slot = (slot - e0 * C).clamp(0, n_loc * C - 1)
        src, filled = src[:, e0 * C:(e0 + n_loc) * C], filled[:, e0 * C:(e0 + n_loc) * C]
    cdt = h.dtype
    rows = h[:, :, None].expand(B, S, K, D).reshape(B, N, D)  # pick n <- token n // K
    xin = _paired_gather(rows, src, filled, slot, valid).reshape(B, n_loc, C, D)
    gate = F.silu(torch.einsum("becd,edf->becf", xin, w1.to(cdt)))
    up = torch.einsum("becd,edf->becf", xin, w3.to(cdt))
    out = torch.einsum("becf,efd->becd", gate * up, w2.to(cdt)).reshape(B, n_loc * C, D)
    gathered = _paired_gather(out, slot, valid, src, filled)  # (B, N, D)
    w = torch.where(valid, gvals, 0.0).to(cdt)
    y = (gathered * w[..., None]).reshape(B, S, K, D).sum(dim=2)
    return y.to(h.dtype), _switch_aux(probs, counts, E, N, seq) if aux else None


def _moe_ffn_einsum(h, router_w, w1, w3, w2, config, experts=None, seq=None, aux=True):
    """Masked-einsum dispatch (the JAX package's ``_moe_ffn_einsum``): the
    one-hot (B, S, K, E, C) slot tensor in the compute dtype (exact 0/1),
    dispatch and combine as einsums. O(S·E·C) memory: C grows with S.
    ``experts``, ``seq`` and ``aux`` as `_moe_ffn_impl`'s."""
    B, S, D = h.shape
    E, K = config.n_experts, config.moe_top_k
    C = moe_capacity(_row_len(S, seq), E, K, config.moe_capacity_factor)
    N = S * K
    e0, n_loc = experts or (0, E)
    probs, _, gvals, onehot, rank, valid, _, counts = _route(h, router_w, E, K, C, seq)
    cdt = h.dtype
    keep = (onehot.reshape(B, S, K, E)[..., e0:e0 + n_loc].to(cdt)
            * valid.reshape(B, S, K, 1).to(cdt))
    # a rank >= C matches no column: dropped picks have an all-zero row
    rank_1h = (rank.reshape(B, S, K, 1) == torch.arange(C, device=h.device)).to(cdt)
    slot = keep[..., None] * rank_1h[..., None, :]  # (B, S, K, E, C)
    dispatch = slot.sum(dim=2)
    combine = (slot * gvals.reshape(B, S, K).to(cdt)[..., None, None]).sum(dim=2)
    xin = torch.einsum("bsec,bsd->becd", dispatch, h)
    gate = F.silu(torch.einsum("becd,edf->becf", xin, w1.to(cdt)))
    up = torch.einsum("becd,edf->becf", xin, w3.to(cdt))
    out = torch.einsum("becf,efd->becd", gate * up, w2.to(cdt))
    y = torch.einsum("bsec,becd->bsd", combine, out)
    return y.to(h.dtype), _switch_aux(probs, counts, E, N, seq) if aux else None


def _expert_slice(config, mesh):
    """``(e0, E_loc, group)`` of this rank on ``mesh``: its first expert,
    its expert count and the ``expert_tensor`` group its partial outputs
    sum over (None: a group of one). Raises ``ValueError`` as the JAX
    package's `_moe_ffn_grouped_ep` does."""
    E = config.n_experts
    ep = int(mesh.shape.get("expert", 1))
    if E % ep != 0:
        raise ValueError(
            f"moe_dispatch='grouped' with ep={ep} needs n_experts % ep == 0 (got E={E})")
    E_loc = E // ep
    return int(mesh.coords.get("expert", 0)) * E_loc, E_loc, mesh.group("expert_tensor")


def _ep_in(x, group):
    """Into the partial path: identity forward, the gradient summed over the
    group backward."""
    if group is None:
        return x
    from pyrecover_tpu_torch.parallel.collectives import tensor_copy

    return tensor_copy(x, group)


def _ep_out(y_part, group, dtype):
    """Out of the partial path: one fp32 all-reduce of the partial outputs
    over the group forward (identity backward), cast to ``dtype``."""
    y = y_part.float()
    if group is not None:
        from pyrecover_tpu_torch.parallel.collectives import tensor_reduce

        y = tensor_reduce(y, group)
    return y.to(dtype)


def _aux_once(h, router_w, config, seq=None):
    """The aux loss from a routing pass on the un-copied values, so its
    gradient flows once (JAX ``:496-503``). It needs the picks' counts, not
    their queue positions: under a sequence axis one integer all-reduce
    makes them the row's."""
    E, K = config.n_experts, config.moe_top_k
    probs, _, _, onehot = _picks(h, router_w, E, K)
    counts = onehot.sum(dim=1).to(torch.int32)
    if seq is not None:
        import torch.distributed as dist

        dist.all_reduce(counts, group=seq[0])
    return _switch_aux(probs, counts, E, h.shape[1] * K, seq)


def _moe_ffn_grouped_ep(h, router_w, w1, w3, w2, config, mesh):
    """Grouped dispatch on a mesh (the JAX package's ``_moe_ffn_grouped_ep``):
    this rank's rows routed over all E experts; the picks of its local
    experts ``[e0, e0 + E_loc)`` sorted to the front by local expert, every
    other pick (another rank's expert, or dropped) to the tail under the
    sentinel ``E_loc``; the grouped products over the first ``M_cap =
    min(B·N, B·E_loc·C)`` sorted rows (at most C valid picks a row and
    expert); the rows past the groups' total zeroed; the combine at gate 0
    for the picks this rank does not hold; one fp32 all-reduce over
    ``expert_tensor``. ``w1``, ``w3`` (E_loc, D, F_loc), ``w2`` (E_loc,
    F_loc, D): this rank's experts, its F slice under tensor."""
    B, S, D = h.shape
    E, K = config.n_experts, config.moe_top_k
    if int(mesh.shape.get("sequence", 1)) > 1:
        raise ValueError(
            "moe_dispatch='grouped' with ep > 1 does not compose with a sharded sequence axis "
            "(it would un-shard the activations); use moe_dispatch='scatter' or 'einsum' "
            "under sp > 1.")
    e0, E_loc, group = _expert_slice(config, mesh)
    C = moe_capacity(S, E, K, config.moe_capacity_factor)
    N = S * K
    cdt = h.dtype
    h_v, rw_v = _ep_in(h, group), _ep_in(router_w, group)
    _, eids, gvals, _, _, valid, _, _ = _route(h_v, rw_v, E, K, C)
    Ml = B * N
    M_cap = min(Ml, B * E_loc * C)
    local = valid & (eids >= e0) & (eids < e0 + E_loc)
    lids = torch.where(local, eids - e0, E_loc).reshape(Ml)
    keep = local.reshape(Ml)
    order = torch.argsort(lids, stable=True)
    inv = torch.argsort(order)
    order_c = order[:M_cap]
    keep_c = keep[order_c]
    # a kept pick sorts before M_cap; the others read a clamped row at gate 0
    inv_c = inv.clamp(max=M_cap - 1)
    picks = h_v[:, :, None].expand(B, S, K, D).reshape(1, Ml, D)
    x = _paired_gather(picks, order_c[None], keep_c[None], inv_c[None], keep[None])[0]
    sizes = (lids[:, None] == torch.arange(E_loc, device=h.device)).sum(dim=0)
    offs = torch.cumsum(sizes, dim=0).to(torch.int32)
    # the last group runs to M_cap: the tail's rows are zero (no kept pick),
    # so every row belongs to a group and SwiGLU maps the tail to zero
    offs[-1] = M_cap
    out = _swiglu_grouped(x, w1.to(cdt), w3.to(cdt), w2.to(cdt), offs)
    row_ok = torch.arange(M_cap, device=h.device) < sizes.sum()
    out = out * row_ok[:, None].to(cdt)
    y_picks = _paired_gather(out[None], inv_c[None], keep[None], order_c[None], keep_c[None])[0]
    wgt = torch.where(local, gvals, 0.0).to(cdt)
    y_part = (y_picks.reshape(B, S, K, D) * wgt.reshape(B, S, K, 1)).sum(dim=2)
    return _ep_out(y_part, group, h.dtype), _aux_once(h, router_w, config)


def _moe_ffn_sharded(backend, h, router_w, w1, w3, w2, config, mesh):
    """``scatter`` or ``einsum`` (``backend``; or ``grouped`` over every
    expert, under a sequence axis) on a mesh: this rank's experts' slots,
    the same copy of ``h`` and the router weight, the same one all-reduce
    and the same aux as `_moe_ffn_grouped_ep` (see the module docstring);
    each row routed whole over the sequence axis (`_route`)."""
    e0, E_loc, group = _expert_slice(config, mesh)
    seq = _seq_ctx(mesh)
    y_part, _ = backend(_ep_in(h, group), _ep_in(router_w, group), w1, w3, w2, config,
                        experts=(e0, E_loc), seq=seq, aux=False)
    return _ep_out(y_part, group, h.dtype), _aux_once(h, router_w, config, seq)


_BACKENDS = {"grouped": _moe_ffn_grouped, "scatter": _moe_ffn_impl, "einsum": _moe_ffn_einsum}
DISPATCH_BACKENDS = tuple(_BACKENDS)
# JAX's auto crossover at ep > 1: the per-device (B, S, K, E, C) slot tensor
# of einsum at 64 Mi elements
EINSUM_SLOT_LIMIT = 64 * 1024 * 1024


def dispatch_backend(config, mesh=None, rows=None, seq_len=None):
    """The backend ``moe_ffn`` runs for ``config.moe_dispatch`` on ``mesh``
    (None: one device's), over this rank's ``rows`` of ``seq_len`` columns
    (a whole row's). JAX's rules: inside a pipeline stage ``einsum``,
    whatever was asked; ``auto`` is ``grouped`` while the expert and
    sequence axes are 1 (``scatter`` at fp32 compute, see the module
    docstring), else ``einsum`` while the rank's ``(B, S, K, E, C)`` slot
    tensor holds at most 64 Mi elements, ``scatter`` past that."""
    choice = config.moe_dispatch
    if choice != "auto" and choice not in _BACKENDS:
        raise ValueError(f"moe_dispatch={choice!r}: expected 'auto' or one of {DISPATCH_BACKENDS}")
    shape = mesh.shape if mesh is not None else {}
    if int(shape.get("pipeline", 1)) > 1:
        return "einsum"
    if choice != "auto":
        return choice
    if config.compute_dtype == "float32":
        return "scatter"
    if int(shape.get("expert", 1)) == 1 and int(shape.get("sequence", 1)) == 1:
        return "grouped"
    E, K = config.n_experts, config.moe_top_k
    C = moe_capacity(seq_len, E, K, config.moe_capacity_factor)
    return "einsum" if rows * seq_len * K * E * C <= EINSUM_SLOT_LIMIT else "scatter"


_WARNED_GROUPED_SP = []  # once a process


def _warn_grouped_sp(sp):
    """JAX's once-a-process warning for an explicit ``grouped`` under a
    sharded sequence axis."""
    if _WARNED_GROUPED_SP:
        return
    _WARNED_GROUPED_SP.append(sp)
    import logging

    from pyrecover_tpu_torch.utils.logging import log_host0

    log_host0("moe_dispatch='grouped' with a sharded sequence axis (sp=%d): the batch-global "
              "sort re-gathers the seq-sharded activations every MoE layer; 'scatter'/'einsum' "
              "keep sp intact", sp, level=logging.WARNING)


def moe_ffn(h, router_w, w1, w3, w2, config, mesh=None):
    """MoE SwiGLU: route each token to its top-k experts, run the expert FFNs,
    combine the outputs weighted by the renormalised gates.

    h (B, S, D) in the compute dtype; router_w (D, E); w1, w3 (E, D, F); w2
    (E, F, D), or on a model-sharded ``mesh`` (a `DeviceMesh`) this rank's
    experts and F slice, and under a sequence axis this rank's S columns of
    each row (routed whole, `_route`). Returns ``(y, aux)``: y (B, S, D) in
    h's dtype, aux (B,) fp32 per-row load-balance loss (the caller scales it
    by ``moe_aux_weight``)."""
    seq = _seq_ctx(mesh)
    name = dispatch_backend(config, mesh, h.shape[0], _row_len(h.shape[1], seq))
    if mesh is None or not mesh.model_sharded:
        return _BACKENDS[name](h, router_w, w1, w3, w2, config)
    if name == "grouped":
        if seq is None or int(mesh.shape.get("expert", 1)) > 1:
            return _moe_ffn_grouped_ep(h, router_w, w1, w3, w2, config, mesh)
        _warn_grouped_sp(seq[2])
    return _moe_ffn_sharded(_BACKENDS[name], h, router_w, w1, w3, w2, config, mesh)
