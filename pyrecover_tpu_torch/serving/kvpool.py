"""Paged KV cache: fixed-size blocks in a preallocated pool, ported from the
JAX package's ``serving/kvpool.py``.

KV storage is one preallocated pool of blocks (``block_size`` token
positions each) on the device. A host-side free list hands blocks to
sequences as they are admitted, and a per-sequence **block table** maps
logical position ``p`` to physical block ``table[p // block_size]``. A
finished sequence releases its blocks mid-flight and the next queued request
claims them; the pool tensors never change shape.

Block 0 is the **trash block**: the free list never hands it out, every
unassigned table slot points at it, and out-of-range or padding writes land
in it. No query ever attends its contents (a key is attended only at
``kpos <= qpos``, and every real position is written before a query reaches
it), so prefill padding and inactive decode slots are harmless writes.

int8 mode stores int8 payloads plus one f32 scale per ``head_dim`` elements
(one per head per token): ``parallel/collectives.py:block_quantize_int8`` at
``block=head_dim``. Per token per layer that is ``2·Hkv·(hd + 4)`` bytes
against ``2·Hkv·hd·itemsize`` natively; `resident_sequences` is the
accounting.

On a serving mesh each rank's pool holds its own part of the KV storage:
its pipeline stage's layers and its tensor piece of the kv heads
(``n_layers`` and ``n_kv_heads``, ``models/decode.py::kv_layout``). Every
rank's block count is reckoned from the WHOLE model's bytes a block
(`from_budget` and `kv_block_bytes` read the model config), so every rank
agrees on it and rank 0's block tables index every rank's pool. The int8
scales are per head per token, so a head split leaves each held head's
scales as the whole pool keeps them.
"""

# The free list and the held map are touched only by ServingEngine._pump,
# which exactly one scheduler thread runs at a time (enforced at run time in
# serving/engine.py): a single-consumer protocol, so there is no lock here.

import numpy as np
import torch

from pyrecover_tpu_torch.utils.device import resolve_device
from pyrecover_tpu_torch.utils.dtypes import resolve_dtype

KV_MODES = ("native", "int8")
TRASH_BLOCK = 0


def kv_token_bytes(config, mode, dtype=None):
    """Bytes of KV storage one token position takes across ALL layers:
    ``native`` at the pool's element dtype (the compute dtype by default),
    ``int8`` at 1 byte an element plus one f32 scale per head."""
    if mode == "int8":
        per_token = 2 * config.n_kv_heads * (config.head_dim + 4)
    else:
        elem = resolve_dtype(dtype or config.compute_dtype).itemsize
        per_token = 2 * config.n_kv_heads * config.head_dim * elem
    return per_token * config.n_layers


def kv_block_bytes(config, block_size, mode, dtype=None):
    """Bytes one pool block (``block_size`` token positions) takes."""
    return kv_token_bytes(config, mode, dtype) * int(block_size)


def blocks_for(seq_len, block_size):
    """Blocks a sequence of ``seq_len`` positions needs (ceil)."""
    return -(-int(seq_len) // int(block_size))


def resident_sequences(budget_bytes, config, block_size, mode, seq_len, dtype=None):
    """How many ``seq_len``-position sequences a pool of ``budget_bytes``
    holds at once (the trash block reserved)."""
    n_blocks = int(budget_bytes) // kv_block_bytes(config, block_size, mode, dtype)
    return max(n_blocks - 1, 0) // blocks_for(seq_len, block_size)


class BlockPool:
    """Preallocated paged KV pool on ``device`` + host-side free list.

    ``arrays``: ``native``: ``{"k", "v"}`` each ``(L, n_blocks, block_size,
    Hkv, head_dim)`` in the pool dtype; ``int8``: ``{"k", "v"}`` int8 of
    that shape plus ``{"k_scale", "v_scale"}`` f32 ``(L, n_blocks,
    block_size, Hkv)``. The paged forward writes them in place. ``L`` and
    ``Hkv`` are the config's unless ``n_layers``/``n_kv_heads`` say a
    serving mesh rank's own.
    """

    def __init__(self, config, n_blocks, block_size, *, kv_mode="native", dtype=None,
                 device="cuda", n_layers=None, n_kv_heads=None):
        if kv_mode not in KV_MODES:
            raise ValueError(f"kv_mode must be one of {KV_MODES}, got {kv_mode!r}")
        if n_blocks < 2:
            raise ValueError(
                f"the pool needs >= 2 blocks (block 0 is reserved as the trash block), "
                f"got {n_blocks}"
            )
        self.config = config
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.kv_mode = kv_mode
        self.dtype = resolve_dtype(dtype or config.compute_dtype)
        self.device = resolve_device(device)
        self.n_layers = int(n_layers or config.n_layers)
        self.n_kv_heads = int(n_kv_heads or config.n_kv_heads)
        shape = (self.n_layers, self.n_blocks, self.block_size, self.n_kv_heads,
                 config.head_dim)
        payload = torch.int8 if kv_mode == "int8" else self.dtype
        self.arrays = {
            "k": torch.zeros(shape, dtype=payload, device=self.device),
            "v": torch.zeros(shape, dtype=payload, device=self.device),
        }
        if kv_mode == "int8":
            self.arrays["k_scale"] = torch.ones(shape[:-1], device=self.device)
            self.arrays["v_scale"] = torch.ones(shape[:-1], device=self.device)
        # LIFO free list over blocks 1..n-1; block 0 stays the trash sink
        self._free = list(range(self.n_blocks - 1, TRASH_BLOCK, -1))
        self._held = {}  # sequence key -> its block ids (leak accounting)

    @classmethod
    def from_budget(cls, config, budget_bytes, block_size, *, kv_mode="native", dtype=None,
                    device="cuda", **layout):
        """As many blocks as ``budget_bytes`` buys (at least 2) at the whole
        model's bytes a block, whatever part ``layout`` holds."""
        per_block = kv_block_bytes(config, block_size, kv_mode, dtype)
        return cls(config, max(int(budget_bytes) // per_block, 2), block_size,
                   kv_mode=kv_mode, dtype=dtype, device=device, **layout)

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def usable_blocks(self):
        """Total allocatable blocks (the pool minus the trash block)."""
        return self.n_blocks - 1

    @property
    def held_blocks(self):
        return sum(len(v) for v in self._held.values())

    def alloc(self, key, n):
        """Take ``n`` blocks for sequence ``key``; None when the free list
        cannot cover all of them (no partial grants: a sequence is admitted
        whole or stays queued)."""
        n = int(n)
        if n <= 0:
            raise ValueError(f"alloc needs a positive block count, got {n}")
        if key in self._held:
            raise ValueError(f"sequence {key!r} already holds blocks")
        if n > len(self._free):
            return None
        # take the tail slice, then commit both sides: a per-block pop loop
        # would strand blocks off the free list if anything raised mid-grant
        got = self._free[-n:][::-1]
        del self._free[-n:]
        self._held[key] = got
        return got

    def release(self, key):
        """Return sequence ``key``'s blocks to the free list; the next
        admission can claim them."""
        blocks = self._held.pop(key)
        self._free.extend(blocks)
        return len(blocks)

    def check_drained(self):
        """Raise unless every non-trash block is back on the free list."""
        if self._held or len(self._free) != self.usable_blocks:
            raise RuntimeError(
                f"KV block leak: {self.held_blocks} blocks still held by "
                f"{sorted(self._held)} and {len(self._free)} of {self.usable_blocks} free"
            )

    def table_width(self, max_model_len):
        """Block-table width covering ``max_model_len`` positions."""
        return blocks_for(max_model_len, self.block_size)

    def block_bytes(self):
        """Bytes one block of this pool takes (this rank's part on a mesh)."""
        whole = kv_block_bytes(self.config, self.block_size, self.kv_mode, self.dtype)
        return whole * self.n_layers * self.n_kv_heads // (self.config.n_layers
                                                            * self.config.n_kv_heads)

    def pool_bytes(self):
        return self.block_bytes() * self.n_blocks


def make_block_table(width, block_ids=None):
    """One sequence's block-table row as int32; unassigned slots point at
    the trash block."""
    row = np.full((int(width),), TRASH_BLOCK, dtype=np.int32)
    if block_ids:
        if len(block_ids) > width:
            raise ValueError(f"{len(block_ids)} blocks exceed the table width {width}")
        row[: len(block_ids)] = block_ids
    return row
