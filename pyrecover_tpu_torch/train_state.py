"""Loss and the train step (one device, or one replica of a data-parallel
group), ported from the JAX package's ``train_state.py``.

The loss is the reference's: sum-reduced cross-entropy on fp32 logits over
labels != IGNORE_INDEX, divided by the number of such labels. An MoE model
trains on that CE plus ``moe_aux_weight`` times the load-balance aux loss
(the mean over the batch's rows of each row's aux summed over the layers);
the ``loss`` metric stays CE only, and ``moe_aux`` is reported beside it.
With gradient accumulation each micro-batch's objective is its CE sum over
the WHOLE batch's label count, plus its rows' share of the aux mean, so the
accumulated gradient equals the unaccumulated one. Unlike the JAX step,
which returns a new state, this step updates the model's parameters and the
optimizer's state in place. Under data parallelism the gradients go through
``DistributedDataParallel`` (fp32, its buckets or one sync after the
backward); ZeRO-1 and the quantized gradient collectives are not ported.

The state bridge (``state_leaves``, ``load_state_leaves``) lays the model,
the optimizer, ``step``, ``epoch`` and ``rng`` out as the JAX ``TrainState``'s
leaves: the same key paths in the same order, dtypes and shapes, so a
checkpoint moves between the packages. ``rng`` is JAX's raw threefry key
data, advanced each step as the JAX step advances it (``rng_fold_in``).
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pyrecover_tpu_torch.checkpoint.vanilla import Leaf, dtype_name
from pyrecover_tpu_torch.models.llama import forward_hidden_with_aux, layer_keys, project_vocab

IGNORE_INDEX = -100  # label mask value (reference dataset.py:50-55)


def masked_ce_sum(logits, labels):
    """Un-normalized CE summed over labels != IGNORE_INDEX.
    Returns ``(loss_sum, n_valid)``."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).long()
    logprobs = F.log_softmax(logits.float(), dim=-1)
    token_ll = torch.gather(logprobs, -1, safe[..., None])[..., 0]
    loss_sum = -torch.sum(torch.where(valid, token_ll, 0.0))
    return loss_sum, valid.sum()


def masked_cross_entropy(logits, labels):
    """CE summed over labels != IGNORE_INDEX, divided by their count.
    Returns ``(loss, n_valid)``."""
    loss_sum, n_valid = masked_ce_sum(logits, labels)
    return loss_sum / n_valid.clamp(min=1).float(), n_valid


def chunked_ce_sum(model, hidden, labels, chunk_size):
    """``(loss_sum, n_valid)`` of the vocab projection + CE, computed over
    sequence chunks of ``chunk_size`` so the full (batch, seq, vocab) logits
    never exist at once. Each chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``) instead of saved. Falls back to one chunk
    when ``chunk_size`` is 0, does not divide the sequence or equals it."""
    s = hidden.shape[1]
    if chunk_size <= 0 or s % chunk_size or s == chunk_size:
        return masked_ce_sum(project_vocab(model, hidden), labels)

    def per_chunk(h, lab):
        return masked_ce_sum(project_vocab(model, h), lab)

    total, count = 0.0, 0
    for i in range(0, s, chunk_size):
        ls, n = checkpoint(
            per_chunk, hidden[:, i:i + chunk_size], labels[:, i:i + chunk_size],
            use_reentrant=False,
        )
        total, count = total + ls, count + n
    return total, count


def chunked_ce(model, hidden, labels, chunk_size):
    """`chunked_ce_sum` divided by the valid-label count."""
    loss_sum, n_valid = chunked_ce_sum(model, hidden, labels, chunk_size)
    return loss_sum / n_valid.clamp(min=1).float(), n_valid


def global_norm(tensors):
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class LossHead(torch.nn.Module):
    """The model's forward and CE sum as one module, ``(inputs, labels,
    segments) -> (ce_sum, n_valid, aux)``, aux the MoE aux loss averaged
    over these rows (0 for a dense model): what ``DistributedDataParallel``
    wraps, so its hooks see the whole forward. The model stays reachable as
    ``.model``; the checkpoint leaves are built from it, never from the
    wrapper, so their names gain no ``module.`` prefix."""

    def __init__(self, model, loss_chunk_size=0):
        super().__init__()
        self.model = model
        self.loss_chunk_size = loss_chunk_size

    def forward(self, inputs, labels, segments=None):
        hidden, aux = forward_hidden_with_aux(self.model, inputs, segments)
        ce_sum, n_valid = chunked_ce_sum(self.model, hidden, labels, self.loss_chunk_size)
        return ce_sum, n_valid, aux


def make_train_step(model, optimizer, loss_chunk_size=0, grad_accumulation_steps=1,
                    grad_bucket_mb=0.0):
    """Build ``step(batch) -> metrics`` for this process's replica.

    ``batch`` holds ``inputs`` and ``labels`` (batch, seq) integer tensors on
    the model's device and optionally ``segments``: this rank's rows of the
    global batch. The step computes the gradients (accumulated over
    ``grad_accumulation_steps`` micro-batches with exact full-batch
    normalization), then ``optimizer.step()``, which clips the synced
    gradients. Metrics are device tensors: ``loss`` (CE only, over the
    global batch), ``n_tokens`` (global), ``grad_norm`` (of the unclipped
    gradients) and ``moe_aux`` (the aux loss over the global batch; 0 for a
    dense model). An MoE model's objective adds ``moe_aux_weight`` times
    the aux loss, each micro-batch's weighted by its share of the rows
    (``pyrecover_tpu/train_state.py:412-428``).

    With a process group of more than one rank the model runs under
    ``DistributedDataParallel`` and the loss is the JAX step's over the
    whole global batch (``pyrecover_tpu/train_state.py:580-610``): the label
    count is all-reduced first and each rank's objective is its CE sum over
    that count times the world size, so DDP's average of the ranks'
    gradients is the gradient of ΣCE / N_global, even when the ranks hold
    different numbers of labels (packed or padded rows). A mean of the
    ranks' own means would not be. Each rank's aux term is its rows' share
    of the global batch's row mean, times the world size, so DDP's average
    gives the gradient of the global mean (JAX ``:430-453``). Every
    micro-step but the last runs under ``no_sync``; with ``grad_bucket_mb`` 0 every micro-step does and
    one all-reduce follows the backward (`collectives.sync_grads_once`).
    With one rank (a group of one included) there is no DDP and no
    collective: the step is the single-device step, bit for bit.
    """
    from pyrecover_tpu_torch.parallel import collectives, mesh

    A = int(grad_accumulation_steps)
    if A < 1:
        raise ValueError(
            f"grad_accumulation_steps must be >= 1, got {grad_accumulation_steps}"
        )
    cfg = model.config
    aux_weight = cfg.moe_aux_weight if cfg.n_experts > 0 else 0.0
    params = [p for p in model.parameters() if p.requires_grad]
    head = LossHead(model, loss_chunk_size)
    world = mesh.world_size()
    ddp = None
    if world > 1:
        ddp = collectives.data_parallel(head, grad_bucket_mb, params[0].device)
    forward = ddp if ddp is not None else head
    tail_sync = ddp is not None and not grad_bucket_mb > 0

    def micro(last):
        """The context of one micro-step's forward and backward."""
        if ddp is None or (last and not tail_sync):
            return contextlib.nullcontext()
        return ddp.no_sync()

    def global_count(labels):
        n = (labels != IGNORE_INDEX).sum()
        if world > 1:
            dist.all_reduce(n)
        return n

    def step(batch):
        inputs, labels = batch["inputs"], batch["labels"]
        segments = batch.get("segments")
        for p in params:
            p.grad = None
        # the global batch's rows: the loader gives every rank an equal share
        rows_total = inputs.shape[0] * world
        if A == 1:
            with micro(True):
                if world == 1:
                    ce_sum, n_valid, aux = forward(inputs, labels, segments)
                    loss = ce_sum / n_valid.clamp(min=1).float()
                    obj = loss + aux_weight * aux if aux_weight else loss
                else:
                    n_valid = global_count(labels)
                    ce_sum, _, aux = forward(inputs, labels, segments)
                    loss = ce_sum / n_valid.clamp(min=1).float() * world
                    # this rank's share of the global row mean, times world
                    aux = aux * (inputs.shape[0] / rows_total)
                    obj = loss + aux_weight * aux * world if aux_weight else loss
                obj.backward()
        else:
            B = inputs.shape[0]
            if B % A:
                raise ValueError(
                    f"batch {B} not divisible by grad_accumulation_steps {A}"
                )
            n_valid = global_count(labels)
            n_total = n_valid.clamp(min=1).float()
            loss = aux = 0.0
            for i, (inp, lab, seg) in enumerate(zip(
                inputs.chunk(A), labels.chunk(A),
                segments.chunk(A) if segments is not None else [None] * A,
            )):
                with micro(i == A - 1):
                    ce_sum, n, a = forward(inp, lab, seg)
                    if world == 1:
                        ce = ce_sum / n.clamp(min=1).float()
                        part = ce * n.clamp(min=1).float() / n_total
                    else:
                        part = ce_sum / n_total * world
                    # the micro-batch's rows' share of the global row mean
                    a = a * (inp.shape[0] / rows_total)
                    obj = part + aux_weight * a * world if aux_weight else part
                    obj.backward()
                loss = loss + part.detach()
                aux = aux + a.detach()
        if tail_sync:
            collectives.sync_grads_once(params, world)
        loss, aux = loss.detach(), aux.detach()
        if world > 1:
            # the ranks' shares of ΣCE / N_global (x world) and of the aux mean
            sums = torch.stack([loss, aux])
            dist.all_reduce(sums)
            loss, aux = sums[0] / world, sums[1]
        with torch.no_grad():
            grad_norm = global_norm([p.grad for p in params])
        optimizer.step()
        return {"loss": loss, "n_tokens": n_valid, "grad_norm": grad_norm, "moe_aux": aux}

    step.ddp = ddp
    return step


def make_eval_step(model, loss_chunk_size=0):
    """Build ``eval_step(batch) -> (ce_sum, n_valid)`` (the JAX package's
    ``make_eval_step``): the un-normalized CE sum over the batch's valid
    labels and their count, through the chunked CE, with the batch's
    segment ids, under ``torch.inference_mode``. Summing both over many
    batches gives the exact mean."""

    @torch.inference_mode()
    def eval_step(batch):
        hidden, _ = forward_hidden_with_aux(model, batch["inputs"], batch.get("segments"))
        ce, n_valid = chunked_ce(model, hidden, batch["labels"], loss_chunk_size)
        return ce * n_valid.clamp(min=1).float(), n_valid

    return eval_step


# ======================= the JAX TrainState's leaves =======================

_MASK32 = 0xFFFFFFFF
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (JAX's PRNG block function) of the
    counter pair (x0, x1) under the 2-word ``key``."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _MASK32, (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def rng_key(seed):
    """``jax.random.key_data(jax.random.key(seed))``: uint32 ``[hi, lo]``."""
    seed = int(seed)
    return np.array([(seed >> 32) & _MASK32, seed & _MASK32], dtype=np.uint32)


def rng_fold_in(key, data):
    """``key_data(fold_in(wrap_key_data(key), data))`` for the threefry PRNG:
    the key's block function over the counter pair ``[0, data]``."""
    return np.array(_threefry2x32(key, 0, int(data) & _MASK32), dtype=np.uint32)


def _param_tree(model):
    """``(key path, tensors)`` of the JAX ``params`` tree, in its flatten
    order (dict keys sorted); a ``layers`` leaf is every layer's tensor,
    stacked on axis 0."""
    tree = [("['final_norm']", [model.final_norm])]
    for key in sorted(layer_keys(model.config)):
        tree.append((f"['layers']['{key}']", [getattr(layer, key) for layer in model.layers]))
    tree += [("['output']", [model.output]), ("['tok_embed']", [model.tok_embed])]
    return tree


def _leaf(path, parts, stacked):
    shape = tuple(parts[0].shape)
    return Leaf(path, (len(parts), *shape) if stacked else shape, dtype_name(parts[0]), parts)


def param_leaves(model):
    """The ``.params[...]`` leaves of the JAX ``TrainState``, in its order,
    over the model's live tensors."""
    return [_leaf(f".params{path}", parts, path.startswith("['layers']"))
            for path, parts in _param_tree(model)]


def state_leaves(model, optimizer, step=0, epoch=0, rng=None):
    """The JAX ``TrainState`` leaves of this model and ``OptaxAdamW``:

        .params[...], {opt}[0].count, {opt}[0].mu[...], {opt}[0].nu[...],
        {opt}[2].count, .step, .epoch, .rng

    where ``{opt}`` is ``.opt_state[1]`` behind global-norm clipping and
    ``.opt_state[0]`` without it. Parameter and moment leaves are the live
    tensors (a save reads them, a restore writes into them); the scalars
    and ``rng`` are numpy arrays that `load_state_leaves` reads back."""
    tree = _param_tree(model)
    opt = ".opt_state[1]" if optimizer.max_norm > 0 else ".opt_state[0]"
    moments = [[optimizer.moments(p) for p in parts] for _, parts in tree]
    leaves = param_leaves(model)
    leaves.append(Leaf(f"{opt}[0].count", (), "int32", [np.array(optimizer.count, np.int32)]))
    for which, name in enumerate(("mu", "nu")):
        for (path, _), pairs in zip(tree, moments):
            leaves.append(_leaf(f"{opt}[0].{name}{path}", [m[which] for m in pairs],
                                path.startswith("['layers']")))
    leaves.append(Leaf(f"{opt}[2].count", (), "int32", [np.array(optimizer.count, np.int32)]))
    rng = rng_key(0) if rng is None else np.asarray(rng, np.uint32)
    for name, value in (("step", np.array(step, np.int32)), ("epoch", np.array(epoch, np.int32)),
                        ("rng", rng.copy())):
        leaves.append(Leaf(f".{name}", value.shape, str(value.dtype), [value]))
    return leaves


def load_state_leaves(leaves, optimizer):
    """After a restore into ``leaves`` (from `state_leaves`): set the
    optimizer's update count, which the two optax ``count`` leaves must
    agree on, and return ``(step, epoch, rng)``."""
    first = {leaf.path: leaf.parts[0] for leaf in leaves}
    counts = [int(v) for path, v in first.items() if path.endswith("].count")]
    if len(set(counts)) != 1:
        raise ValueError(f"the optimizer state's count leaves disagree: {counts}")
    optimizer.count = counts[0]
    return int(first[".step"]), int(first[".epoch"]), first[".rng"].copy()
