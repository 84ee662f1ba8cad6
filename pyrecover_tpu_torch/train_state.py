"""Loss and the single-device train step, ported from the JAX package's
``train_state.py``.

The loss is the reference's: sum-reduced cross-entropy on fp32 logits over
labels != IGNORE_INDEX, divided by the number of such labels. With gradient
accumulation each micro-batch's objective is its CE sum over the WHOLE
batch's label count, so the accumulated gradient equals the unaccumulated
one. Unlike the JAX step, which returns a new state, this step updates the
model's parameters and the optimizer's state in place. ZeRO-1, quantized
and bucketed gradient collectives are not ported.
"""

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pyrecover_tpu_torch.models.llama import forward_hidden_with_aux, project_vocab

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


def make_train_step(model, optimizer, loss_chunk_size=0, grad_accumulation_steps=1):
    """Build ``step(batch) -> metrics`` for one device.

    ``batch`` holds ``inputs`` and ``labels`` (batch, seq) integer tensors on
    the model's device and optionally ``segments``. The step computes the
    gradients (accumulated over ``grad_accumulation_steps`` micro-batches
    with exact full-batch normalization), then ``optimizer.step()``. Metrics
    are device tensors: ``loss`` (CE only), ``n_tokens`` and ``grad_norm``
    (of the unclipped gradients).
    """
    A = int(grad_accumulation_steps)
    if A < 1:
        raise ValueError(
            f"grad_accumulation_steps must be >= 1, got {grad_accumulation_steps}"
        )
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch):
        inputs, labels = batch["inputs"], batch["labels"]
        segments = batch.get("segments")
        for p in params:
            p.grad = None
        if A == 1:
            hidden, _ = forward_hidden_with_aux(model, inputs, segments)
            loss, n_valid = chunked_ce(model, hidden, labels, loss_chunk_size)
            loss.backward()
        else:
            B = inputs.shape[0]
            if B % A:
                raise ValueError(
                    f"batch {B} not divisible by grad_accumulation_steps {A}"
                )
            n_valid = (labels != IGNORE_INDEX).sum()
            n_total = n_valid.clamp(min=1).float()
            loss = 0.0
            for inp, lab, seg in zip(
                inputs.chunk(A), labels.chunk(A),
                segments.chunk(A) if segments is not None else [None] * A,
            ):
                hidden, _ = forward_hidden_with_aux(model, inp, seg)
                ce, n = chunked_ce(model, hidden, lab, loss_chunk_size)
                obj = ce * n.clamp(min=1).float() / n_total
                obj.backward()
                loss = loss + obj.detach()
        with torch.no_grad():
            grad_norm = global_norm([p.grad for p in params])
        optimizer.step()
        return {"loss": loss.detach(), "n_tokens": n_valid, "grad_norm": grad_norm}

    return step
