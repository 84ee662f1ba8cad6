"""Stateful, checkpointable global-batch sampler (the JAX package's
``data/sampler.py::StatefulSampler``, copied).

Data order is a pure function of (seed, epoch) and the position is an
explicit cursor, so the sampler's ``state_dict`` restores exactly. The epoch
boundary advances the permutation and yields a fresh batch; no batch is
trained twice. Under data parallelism every rank runs the same global
sampler and takes its own rows of each global batch (``data/loader.py``);
``split_sampler_state``, ``merge_sampler_states`` and
``rescale_sampler_state`` make the per-replica view explicit, so a resume
at another replica count can show that no sample is skipped or repeated.
"""

import numpy as np

# concur: disable-file=unguarded-shared-state -- single-consumer by protocol: only the loader's producer thread calls next_batch() after start(), and every main-thread mutation (seek/load_state_dict on resume) happens strictly before DataLoader.start() spawns it (Thread.start() is the happens-before edge); state_dict_at reads only the fields no thread mutates


class StatefulSampler:
    """Yields global index batches; deterministic; exactly resumable."""

    def __init__(self, dataset_len, global_batch_size, seed=0, shuffle=True,
                 num_samples=None):
        if global_batch_size <= 0:
            raise ValueError("global_batch_size must be positive")
        self.dataset_len = int(dataset_len)
        # virtual length with wraparound (reference dataset.py:25-28)
        self.num_samples = int(num_samples) if num_samples else self.dataset_len
        self.global_batch_size = int(global_batch_size)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.epoch = 0
        self.cursor = 0  # index into the epoch's permutation, in samples
        self._perm = None
        self._perm_epoch = None

    # -- deterministic permutation per (seed, epoch) -------------------------
    def _permutation(self):
        if self._perm is None or self._perm_epoch != self.epoch:
            if self.shuffle:
                rng = np.random.Generator(
                    np.random.Philox(key=[self.seed, self.epoch])
                )
                self._perm = rng.permutation(self.num_samples)
            else:
                self._perm = np.arange(self.num_samples)
            self._perm_epoch = self.epoch
        return self._perm

    @property
    def batches_per_epoch(self):
        return self.num_samples // self.global_batch_size  # drop_last

    def next_batch(self):
        """Return the next global batch of dataset indices; advances state."""
        if self.cursor + self.global_batch_size > self.num_samples:
            self.epoch += 1
            self.cursor = 0
        perm = self._permutation()
        idx = perm[self.cursor : self.cursor + self.global_batch_size]
        self.cursor += self.global_batch_size
        return idx % self.dataset_len

    def __iter__(self):
        while True:
            yield self.next_batch()

    def seek(self, consumed_batches):
        """Position the sampler as if ``consumed_batches`` global batches had
        been drawn since a fresh start. Because data order is a pure function
        of (seed, epoch), the position is a pure function of the trained-step
        count — this is what makes resume exact even though the prefetching
        loader runs the sampler ahead of consumption."""
        bpe = self.batches_per_epoch
        if bpe <= 0:
            raise ValueError("dataset smaller than one global batch")
        self.epoch = int(consumed_batches) // bpe
        self.cursor = (int(consumed_batches) % bpe) * self.global_batch_size
        self._perm = None
        self._perm_epoch = None

    def state_dict_at(self, consumed_batches):
        """`state_dict` as it stands after ``consumed_batches`` batches drawn
        from a fresh start (as `seek` places it), whatever the live cursor
        says: what a checkpoint records while a prefetching loader runs the
        sampler ahead of the step."""
        state = self.state_dict()
        bpe = self.batches_per_epoch
        if bpe > 0:
            state["epoch"] = int(consumed_batches) // bpe
            state["cursor"] = (int(consumed_batches) % bpe) * self.global_batch_size
        return state

    # -- checkpointable state (the reference's missing sampler state) --------
    def state_dict(self):
        return {
            "epoch": self.epoch,
            "cursor": self.cursor,
            "seed": self.seed,
            "global_batch_size": self.global_batch_size,
            "num_samples": self.num_samples,
            "shuffle": self.shuffle,
        }

    def load_state_dict(self, state):
        if int(state["global_batch_size"]) != self.global_batch_size:
            raise ValueError(
                "Cannot resume with a different global batch size: "
                f"checkpoint={state['global_batch_size']} current={self.global_batch_size}"
            )
        self.epoch = int(state["epoch"])
        self.cursor = int(state["cursor"])
        self.seed = int(state["seed"])
        self.num_samples = int(state["num_samples"])
        self.shuffle = bool(state["shuffle"])
        self._perm = None
        self._perm_epoch = None


# -- per-replica state decomposition (topology-elastic resume) ----------------
#
# Data order is a pure function of (seed, epoch) and the position is one
# global cursor, so the per-replica view is derived, not stored: replica r
# of n consumes rows [r*gbs/n, (r+1)*gbs/n) of every global batch. These
# helpers make that decomposition explicit and reversible so an elastic
# resume (N data-parallel replicas at save time, M at restore) can prove
# no sample is skipped or double-consumed when the replica count changes.

_REPLICA_KEYS = ("epoch", "cursor", "seed", "global_batch_size",
                 "num_samples", "shuffle")


def split_sampler_state(state, n_replicas):
    """Split one global sampler state into ``n_replicas`` per-replica
    views. Deterministic; ``merge_sampler_states`` inverts it exactly.
    Raises ``ValueError`` when the global batch does not divide evenly —
    a replica count the data pipeline cannot serve."""
    n = int(n_replicas)
    gbs = int(state["global_batch_size"])
    cursor = int(state["cursor"])
    if n <= 0:
        raise ValueError(f"replica count must be positive, got {n}")
    if gbs % n != 0:
        raise ValueError(
            f"global batch size {gbs} not divisible by {n} replicas"
        )
    if cursor % gbs != 0:
        raise ValueError(
            f"cursor {cursor} is not on a global-batch boundary (gbs {gbs})"
        )
    out = []
    for r in range(n):
        view = {k: state[k] for k in _REPLICA_KEYS if k in state}
        view.update({
            "replica": r,
            "n_replicas": n,
            # rows of each global batch this replica consumes
            "local_rows": [r * gbs // n, (r + 1) * gbs // n],
            # batches consumed so far — identical on every replica by
            # construction; merge validates exactly that
            "consumed_batches": cursor // gbs,
        })
        out.append(view)
    return out


def merge_sampler_states(states):
    """Merge per-replica views back into one global sampler state.

    Validates the set is complete (replicas 0..n-1, no gaps or dupes) and
    CONSISTENT — every replica must agree on seed/epoch/progress. A
    divergence means the replicas were not sampling the same global
    sequence, and silently picking one would replay or skip data; raise
    instead."""
    if not states:
        raise ValueError("no replica states to merge")
    n = int(states[0].get("n_replicas", len(states)))
    ids = sorted(int(s.get("replica", -1)) for s in states)
    if len(states) != n or ids != list(range(n)):
        raise ValueError(
            f"incomplete/duplicated replica set: got ids {ids}, want 0..{n - 1}"
        )
    base = {k: states[0][k] for k in _REPLICA_KEYS if k in states[0]}
    base_progress = states[0].get("consumed_batches")
    for s in states[1:]:
        for k in _REPLICA_KEYS:
            if k in base and s.get(k) != base[k]:
                raise ValueError(
                    f"replica {s.get('replica')} diverged on {k}: "
                    f"{s.get(k)!r} != {base[k]!r}"
                )
        if s.get("consumed_batches") != base_progress:
            raise ValueError(
                f"replica {s.get('replica')} diverged on progress: "
                f"{s.get('consumed_batches')} batches != {base_progress}"
            )
    return base


def rescale_sampler_state(state, new_replicas):
    """Re-derive a saved global sampler state for a NEW data-parallel
    replica count: merge-equivalent validation + a fresh split. The
    global cursor (and therefore the sample sequence) is preserved
    exactly — the same global batches are consumed in the same order,
    only the per-replica slicing changes. Returns ``(global_state,
    per_replica_states)``; raises ``ValueError`` when the rescale is
    infeasible (indivisible global batch)."""
    views = split_sampler_state(state, new_replicas)
    merged = merge_sampler_states(views)
    for k in _REPLICA_KEYS:
        if k in state and merged.get(k) != state[k]:  # pragma: no cover
            raise ValueError(f"rescale round-trip drifted on {k}")
    return merged, views
