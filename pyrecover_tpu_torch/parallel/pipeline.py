"""Pipeline parallelism over the ``pipeline`` group: the JAX package's
``parallel/pipeline.py`` as per-stage processes.

Each stage process holds ``n_layers / S`` blocks (``parallel/sharding.py``:
`stage_layers`, contiguous, or at ``pp_virtual_stages`` V above 1 its V
chunks ``j * S + s``) and the whole embedding, final norm and output, as
JAX's rules place them. A batch splits into ``M`` microbatches of
contiguous rows (``pp_microbatches``, 0: the stage count). The carry that
crosses a stage boundary is the activation ``x`` (``(b/M, s, dim)``, the
compute dtype) and the per-row MoE aux (``(b/M,)`` fp32): the aux rides the
pipeline carry, as in JAX. Activations go forward and their cotangents
back by point-to-point sends (``parallel/mesh.py::p2p_exchange``), each
tick's sends and receives posted at once.

The schedules:

* GPipe (`pipeline_gpipe_grads`): all M forwards, each stage keeping its
  autograd graph, then all M backwards in reverse order. In JAX the
  backward is what AD derives through the scanned ``ppermute`` forward;
  here it is autograd through each stage's graph with the cotangents sent
  back: the same dataflow. Without its backward it is the eval's forward,
  through every stage's V chunks in their logical order.
* 1F1B and interleaved 1F1B (`pipeline_1f1b_grads`): JAX's static tables
  (`build_1f1b_tables`, `build_interleaved_tables`, equal element for
  element) executed tick by tick on each stage. A stage forwards the
  microbatch its row names, backwards the one its other row names, and
  at the end of the tick sends what the next stage's row will consume one
  tick later. JAX's backward tick recomputes the chunk from its saved
  input; the port keeps the forward's graph instead (one flash forward a
  layer and microbatch, two under ``full`` remat).

On a composed mesh a stage's blocks are sharded over the stage's own
groups (``parallel/sharding.py::shard_model``: the tensor and expert
slices, then FSDP2 over the stage's fsdp group), and the ring and the
experts run over the stage's sequence and expert groups; the pipeline's
sends pair each rank with the rank of the next stage at its coordinates on
the other axes. A stage's part of a microbatch runs inside the model's own
call (``Transformer.forward``'s ``stage``), where FSDP2's hooks gather what
it needs.

The embedding runs on logical stage 0 inside its graph, so its gradient
comes from stage 0's input cotangent, as JAX's ``embed_vjp`` closes the
chain outside the pipeline. The loss head (final norm, vocab projection,
CE over the labels, plus the aux term) runs on the last logical stage, as
JAX's ``head_fn``: its objective is ``ce_sum / n_total + w * aux_sum /
rows``, n_total the global label count and rows the global batch's.

JAX's queued and replicated microbatch buffers (``stage_program_queued``,
``FORCE_REPLICATED_BUFFERS``) and its rotating boundary queues are
artifacts of one SPMD program in which every stage holds a slice of every
buffer; here each stage is its own process that holds only its own
microbatches, so they have no counterpart.
"""

import functools

import numpy as np
import torch

AXIS_PIPE = "pipeline"


# ---- JAX's static schedule tables (plain functions, equal element for element) ----


@functools.lru_cache(maxsize=None)
def build_1f1b_tables(n_microbatches, n_stages):
    """Static (T, S) fwd/bwd action tables for non-interleaved 1F1B
    (JAX ``build_1f1b_tables``): ``fwd[t, s]`` / ``bwd[t, s]`` is the
    microbatch stage ``s`` forwards / backwards at tick ``t``, or -1.
    Greedy simulation of the textbook schedule: per stage every microbatch
    is forwarded and backwarded once in order, dependencies hold with a
    one-tick transfer delay, T = 2(M+S-1), and at most min(S, M)
    microbatches are in flight on a stage."""
    M, S = n_microbatches, n_stages
    n_warm = [min(S - s, M) for s in range(S)]
    fwd_done = [[-1] * M for _ in range(S)]
    bwd_done = [[-1] * M for _ in range(S)]
    next_f = [0] * S
    next_b = [0] * S
    credits = [0] * S
    fwd_rows, bwd_rows = [], []
    t = 0
    while any(next_b[s] < M for s in range(S)):
        frow = [-1] * S
        brow = [-1] * S
        for s in range(S):
            m_f, m_b = next_f[s], next_b[s]
            can_f = m_f < M and (
                s == 0 or (fwd_done[s - 1][m_f] >= 0 and fwd_done[s - 1][m_f] < t))
            can_b = m_b < M and (
                (s == S - 1 and fwd_done[s][m_b] >= 0 and fwd_done[s][m_b] < t)
                or (s < S - 1 and bwd_done[s + 1][m_b] >= 0 and bwd_done[s + 1][m_b] < t))
            if next_f[s] < n_warm[s]:
                if can_f:
                    frow[s] = m_f
            else:
                if can_b:
                    brow[s] = m_b
                elif can_f and credits[s] > 0:
                    frow[s] = m_f
        for s in range(S):
            if frow[s] >= 0:
                if next_f[s] >= n_warm[s]:
                    credits[s] -= 1
                fwd_done[s][frow[s]] = t
                next_f[s] += 1
            if brow[s] >= 0:
                bwd_done[s][brow[s]] = t
                next_b[s] += 1
                credits[s] += 1
        fwd_rows.append(frow)
        bwd_rows.append(brow)
        t += 1
        if t > 4 * (M + S) + 8:
            raise RuntimeError("1f1b schedule construction did not converge")
    return np.array(fwd_rows, np.int32), np.array(bwd_rows, np.int32)


@functools.lru_cache(maxsize=None)
def build_interleaved_tables(n_microbatches, n_stages, n_virtual):
    """Static (T, S) action tables for interleaved (virtual-stage) 1F1B
    (JAX ``build_interleaved_tables``): logical stage ``c * S + s`` runs
    chunk ``c`` on physical stage ``s``; each stage follows Megatron-LM's
    interleaved order (a warmup of 2(S-s-1) + (V-1)S chunk-forwards, then
    strict forward/backward alternation), each action firing as soon as its
    dependency (one-tick transfer delay) is met. Returns ``(fwd_mb, fwd_ck,
    bwd_mb, bwd_ck, buf_slots)``; requires ``M % S == 0``."""
    M, S, V = n_microbatches, n_stages, n_virtual
    if M % S:
        raise ValueError(
            f"interleaved 1F1B needs pp_microbatches ({M}) divisible by "
            f"the stage count ({S})")
    SL = S * V
    total = V * M

    def fwd_action(i):
        return (i % SL) // S, S * (i // SL) + i % S

    def bwd_action(j):
        return V - 1 - (j % SL) // S, S * (j // SL) + j % S

    seqs = []
    for s in range(S):
        warm = min((S - s - 1) * 2 + (V - 1) * S, total)
        seq = [("f",) + fwd_action(i) for i in range(warm)]
        nf, nb = warm, 0
        while nf < total or nb < total:
            if nf < total:
                seq.append(("f",) + fwd_action(nf))
                nf += 1
            if nb < total:
                seq.append(("b",) + bwd_action(nb))
                nb += 1
        seqs.append(seq)

    ptr = [0] * S
    fwd_done, bwd_done = {}, {}
    fm_rows, fc_rows, bm_rows, bc_rows = [], [], [], []
    t = 0
    while any(ptr[s] < len(seqs[s]) for s in range(S)):
        fm, fc = [-1] * S, [-1] * S
        bm, bc = [-1] * S, [-1] * S
        fired = []
        for s in range(S):
            if ptr[s] >= len(seqs[s]):
                continue
            kind, c, m = seqs[s][ptr[s]]
            ell = c * S + s
            if kind == "f":
                if ell == 0 or fwd_done.get((ell - 1, m), t) < t:
                    fm[s], fc[s] = m, c
                    fired.append(("f", ell, m, s))
            else:
                if ell == SL - 1:
                    ready = fwd_done.get((ell, m), t) < t
                else:
                    ready = bwd_done.get((ell + 1, m), t) < t
                if ready:
                    bm[s], bc[s] = m, c
                    fired.append(("b", ell, m, s))
        for kind, ell, m, s in fired:
            (fwd_done if kind == "f" else bwd_done)[(ell, m)] = t
            ptr[s] += 1
        fm_rows.append(fm)
        fc_rows.append(fc)
        bm_rows.append(bm)
        bc_rows.append(bc)
        t += 1
        if t > 16 * V * (M + S) + 32:
            raise RuntimeError("interleaved 1f1b schedule construction did not converge")
    assert len(fwd_done) == len(bwd_done) == SL * M
    buf_slots = 0
    for ell in range(SL):
        events = sorted([(fwd_done[(ell, m)], 1) for m in range(M)]
                        + [(bwd_done[(ell, m)], -1) for m in range(M)])
        cur = peak = 0
        for _, d in events:
            cur += d
            peak = max(peak, cur)
        buf_slots = max(buf_slots, peak)
    return (np.array(fm_rows, np.int32), np.array(fc_rows, np.int32),
            np.array(bm_rows, np.int32), np.array(bc_rows, np.int32), buf_slots)


def interleave_layer_chunks(x, S, V):
    """(L, ...) layer-stacked array -> interleaved order, so a contiguous
    split hands stage s its V chunks {j S + s}: position (s, j, c) <- layer
    (j S + s) cl + c, cl = L/(S V) (JAX ``interleave_layer_chunks`` on one
    leaf, numpy or torch)."""
    cl = x.shape[0] // (S * V)
    y = x.reshape(V, S, cl, *x.shape[1:]).swapaxes(0, 1)
    return y.reshape(S * V * cl, *x.shape[1:])


def uninterleave_layer_chunks(x, S, V):
    """Inverse of `interleave_layer_chunks`."""
    cl = x.shape[0] // (S * V)
    y = x.reshape(S, V, cl, *x.shape[1:]).swapaxes(0, 1)
    return y.reshape(S * V * cl, *x.shape[1:])


def check_pipeline(n_layers, batch, S, M, V):
    """JAX's divisibility rules (``pipeline.py:131-137, 579-585``), with its
    words."""
    if batch % M:
        raise ValueError(f"batch {batch} not divisible by {M} microbatches")
    if V == 1 and n_layers % S:
        raise ValueError(f"n_layers={n_layers} not divisible by pipeline stages (--pp) {S}")
    if n_layers % (S * V):
        raise ValueError(
            f"n_layers={n_layers} not divisible by pipeline stages (--pp) "
            f"{S} x virtual stages (--pp-virtual-stages) {V}")


# ---- the stage program ----------------------------------------------------------


class _Stage:
    """One stage's part of one step: its chunks of blocks, the microbatches'
    companions, the forward and backward of one (chunk, microbatch), and
    the sends between stages."""

    def __init__(self, model, mesh, batch, n_total, rows_total, aux_weight, chunk_size, M, V):
        from pyrecover_tpu_torch.models.llama import _attention_fn, rope_tables
        from pyrecover_tpu_torch.parallel.mesh import p2p_ready
        from pyrecover_tpu_torch.utils.dtypes import resolve_dtype

        self.model, self.mesh, self.cfg = model, mesh, model.config
        self.S, self.s, self.M, self.V = mesh.shape[AXIS_PIPE], mesh.coords[AXIS_PIPE], M, V
        cl = len(model.layers) // V
        self.chunks = [list(model.layers)[c * cl:(c + 1) * cl] for c in range(V)]
        inputs, labels = batch["inputs"], batch["labels"]
        seg = batch.get("segments")
        self.inputs, self.labels = inputs.chunk(M), labels.chunk(M)
        self.segs = [None] * M if seg is None else list(seg.to(torch.int32).chunk(M))
        self.cos, self.sin = rope_tables(model, inputs)
        self.attn_fn = _attention_fn(self.cfg, mesh)
        self.n_total, self.rows_total = n_total, rows_total
        self.aux_weight, self.chunk_size = aux_weight, chunk_size
        b = inputs.shape[0] // M
        dev = inputs.device
        self.x_like = torch.empty((b, inputs.shape[1], self.cfg.dim),
                                  dtype=resolve_dtype(self.cfg.compute_dtype), device=dev)
        self.aux_like = torch.empty((b,), dtype=torch.float32, device=dev)
        self.nxt = mesh.neighbour(AXIS_PIPE, 1)
        self.prev = mesh.neighbour(AXIS_PIPE, -1)
        self.group = mesh.group(AXIS_PIPE)
        p2p_ready(dev, self.group)  # every stage, before a tick sends between two
        self.ce_sum = torch.zeros((), dtype=torch.float32, device=dev)
        self.aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
        self.backwards_left = [M] * V  # a chunk's backwards still to run
        self.saved = {}  # (chunk, m) -> (x_in, aux_in, outputs)
        self.inbox = {}  # (chunk, m) -> received (x, aux)
        self.ctbox = {}  # (chunk, m) -> received cotangents

    def first(self, c):
        return self.s == 0 and c == 0

    def last(self, c):
        return self.s == self.S - 1 and c == self.V - 1

    def forward(self, c, m):
        """Forward chunk ``c`` of microbatch ``m``: returns the carry to send
        (None on the last logical stage, where the head runs now). It runs
        inside the model's own call (``Transformer.forward``'s ``stage``), so
        under fsdp FSDP2 gathers the embedding and output for it and each
        block's slices as the block runs (their gradients' reduce-scatter:
        `_gradient_sync`)."""
        inputs = []
        out = self.model(stage=lambda: self._forward(c, m, inputs))
        self.saved[(c, m)] = (*inputs, out)
        return None if self.last(c) else (out[0].detach(), out[1].detach())

    def _forward(self, c, m, inputs):
        """`forward`'s work: the objective on the last logical stage, else
        the carry ``(x, aux)``; the chunk's inputs go into ``inputs`` (not
        returned: FSDP2 hooks what the model's call returns)."""
        from pyrecover_tpu_torch.models.llama import embed_tokens

        if self.first(c):
            x_in = embed_tokens(self.model, self.inputs[m])
            aux_in = torch.zeros_like(self.aux_like)
        else:
            x_in, aux_in = self.inbox.pop((c, m))
            x_in.requires_grad_(True)
            aux_in.requires_grad_(True)
        x, aux = x_in, aux_in
        for layer in self.chunks[c]:
            x, a = layer(x, self.cos, self.sin, self.cfg, self.attn_fn, self.segs[m])
            aux = aux + a
        inputs += [x_in, aux_in]
        return self._head(x, aux, m) if self.last(c) else (x, aux)

    def _head(self, x, aux, m):
        """The last logical stage's loss head: the objective (a scalar)."""
        from pyrecover_tpu_torch.models.llama import rms_norm
        from pyrecover_tpu_torch.train_state import chunked_ce_sum

        hidden = rms_norm(x, self.model.final_norm, self.cfg.norm_eps)
        ce_sum, _ = chunked_ce_sum(self.model, hidden, self.labels[m], self.chunk_size)
        aux_sum = aux.sum()
        self.ce_sum += ce_sum.detach()
        self.aux_sum += aux_sum.detach()
        obj = ce_sum / self.n_total
        if self.aux_weight:
            obj = obj + self.aux_weight * aux_sum / self.rows_total
        return obj

    def backward(self, c, m):
        """Backward chunk ``c`` of microbatch ``m``: returns the input
        cotangents to send (None on logical stage 0)."""
        self._gradient_sync(c)
        x_in, aux_in, out = self.saved.pop((c, m))
        if self.last(c):
            out.backward()
        else:
            pairs = [(o, ct) for o, ct in zip(out, self.ctbox.pop((c, m))) if o.requires_grad]
            torch.autograd.backward([o for o, _ in pairs], [ct for _, ct in pairs])
        if self.first(c):
            return None
        # an input the objective does not reach (a dense model's aux) sends zeros
        return tuple(t.grad if t.grad is not None else torch.zeros_like(t)
                     for t in (x_in, aux_in))

    def _gradient_sync(self, c):
        """Before a backward of chunk ``c`` under fsdp (the model and each
        block FSDP2 modules): a block's gradients are reduce-scattered at
        its chunk's last microbatch, the model's own (the embedding and the
        output) at the stage's last backward, and only accumulated before,
        so a step reduce-scatters once, as JAX sums over the microbatches
        first."""
        self.backwards_left[c] -= 1
        if not hasattr(self.model, "set_requires_gradient_sync"):
            return
        for block in self.chunks[c]:
            block.set_requires_gradient_sync(self.backwards_left[c] == 0, recurse=False)
        self.model.set_requires_gradient_sync(not any(self.backwards_left), recurse=False)

    def exchange(self, fwd_send, bwd_send, fwd_recv, bwd_recv):
        """One tick's sends and receives: ``fwd_send`` / ``bwd_send`` the
        carry to the next stage / the cotangents to the previous one (or
        None); ``fwd_recv`` / ``bwd_recv`` the (chunk, m) keys this stage
        receives a carry / cotangents for (or None). Forward traffic is
        listed first on both sides."""
        from pyrecover_tpu_torch.parallel.mesh import p2p_exchange

        sends = []
        if fwd_send is not None:
            sends += [(t, self.nxt) for t in fwd_send]
        if bwd_send is not None:
            sends += [(t, self.prev) for t in bwd_send]
        recvs = []
        if fwd_recv is not None:
            recvs += [(self.x_like, self.prev), (self.aux_like, self.prev)]
        if bwd_recv is not None:
            recvs += [(self.x_like, self.nxt), (self.aux_like, self.nxt)]
        if not sends and not recvs:
            return
        got = p2p_exchange(sends, recvs, self.group)
        if fwd_recv is not None:
            self.inbox[fwd_recv] = (got[0], got[1])
            got = got[2:]
        if bwd_recv is not None:
            self.ctbox[bwd_recv] = (got[0], got[1])


def pipeline_gpipe_grads(model, mesh, batch, n_total, rows_total, aux_weight, chunk_size, M,
                         V=1, backward=True):
    """GPipe: all M forwards, each through the V chunks in their logical
    order (chunk 0 on stages 0 to S-1, then chunk 1 on each, and so on: the
    last stage's carry wraps to stage 0's next chunk), then all M backwards
    in reverse order, each stage's
    parameter gradients accumulated by autograd. With ``backward`` False it
    is the pipeline's forward alone (an eval, under ``no_grad``), and each
    (chunk, microbatch)'s graph is dropped as soon as it has run. Returns
    this stage's ``(ce_sum, aux_sum)`` (nonzero on the last stage only)."""
    st = _Stage(model, mesh, batch, n_total, rows_total, aux_weight, chunk_size, M, V)
    for m in range(M):
        for c in range(V):
            if not st.first(c):
                st.exchange(None, None, (c, m), None)
            sent = st.forward(c, m)
            if not backward:
                st.saved.clear()
            if sent is not None:
                st.exchange(sent, None, None, None)
    if backward:
        for m in reversed(range(M)):
            for c in reversed(range(V)):
                if not st.last(c):
                    st.exchange(None, None, None, (c, m))
                sent = st.backward(c, m)
                if sent is not None:
                    st.exchange(None, sent, None, None)
    return st.ce_sum, st.aux_sum


def pipeline_1f1b_grads(model, mesh, batch, n_total, rows_total, aux_weight, chunk_size, M,
                        V=1):
    """1F1B (V 1) or interleaved 1F1B (V above 1) from JAX's tables, tick by
    tick. Returns this stage's ``(ce_sum, aux_sum)``."""
    S = mesh.shape[AXIS_PIPE]
    if V == 1:
        fwd, bwd = build_1f1b_tables(M, S)
        fck = np.where(fwd >= 0, 0, -1)
        bck = np.where(bwd >= 0, 0, -1)
    else:
        fwd, fck, bwd, bck, _ = build_interleaved_tables(M, S, V)
    st = _Stage(model, mesh, batch, n_total, rows_total, aux_weight, chunk_size, M, V)
    s = st.s
    p, n = (s - 1) % S, (s + 1) % S
    for t in range(fwd.shape[0]):
        fwd_send = bwd_send = None
        if fwd[t, s] >= 0:
            fwd_send = st.forward(int(fck[t, s]), int(fwd[t, s]))
        if bwd[t, s] >= 0:
            bwd_send = st.backward(int(bck[t, s]), int(bwd[t, s]))
        # what the neighbours send at the end of this tick (JAX's adoption
        # rule: a wrap send S-1 -> 0 advances the chunk, 0 -> S-1 lowers it)
        fwd_recv = bwd_recv = None
        sfm, sfc = int(fwd[t, p]), int(fck[t, p])
        if sfm >= 0 and (s > 0 or (V > 1 and sfc < V - 1)):
            fwd_recv = (sfc + 1 if s == 0 else sfc, sfm)
        sbm, sbc = int(bwd[t, n]), int(bck[t, n])
        if sbm >= 0 and (s < S - 1 or (V > 1 and sbc > 0)):
            bwd_recv = (sbc - 1 if s == S - 1 else sbc, sbm)
        st.exchange(fwd_send, bwd_send, fwd_recv, bwd_recv)
    return st.ce_sum, st.aux_sum
