"""Causal-LM collation: shift-by-one and pad masking (the JAX package's
``data/collate.py``, copied).

Given tokenized items of length seq_len+1, inputs are tokens[:-1] and labels
tokens[1:] with pad positions set to IGNORE_INDEX (-100). Packed items
(``(tokens, segment_ids)`` tuples) also carry per-position segment ids: the
label at each document's last position and padding (segment
``PAD_SEGMENT``) are masked, and labels are not masked by token value.
"""

import numpy as np

from pyrecover_tpu_torch.train_state import IGNORE_INDEX

# segment id reserved for padding positions (no real row uses it): the
# collator masks their labels, and they match no real segment in attention
PAD_SEGMENT = -1


def collate_clm(items, pad_token_id):
    """items: sequence of int32 arrays, each (seq_len + 1,) — or, packed,
    of ``(tokens, segment_ids)`` tuples of such arrays.

    Returns dict of numpy arrays: inputs (B, S) int32, labels (B, S) int32,
    plus segments (B, S) int32 for packed items.
    """
    if isinstance(items[0], tuple):
        toks = np.stack([t for t, _ in items]).astype(np.int32)
        segs = np.stack([s for _, s in items]).astype(np.int32)
        inputs = toks[:, :-1]
        labels = toks[:, 1:].copy()
        seg_in = segs[:, :-1].copy()
        seg_lab = segs[:, 1:]
        # cross-document predictions and padding drop out of the loss
        labels[seg_lab != seg_in] = IGNORE_INDEX
        labels[seg_lab == PAD_SEGMENT] = IGNORE_INDEX
        return {"inputs": inputs, "labels": labels, "segments": seg_in}
    batch = np.stack(items).astype(np.int32)
    inputs = batch[:, :-1]
    labels = batch[:, 1:].copy()
    labels[labels == pad_token_id] = IGNORE_INDEX
    return {"inputs": inputs, "labels": labels}
