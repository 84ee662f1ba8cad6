"""ZeRO-1 and the error-feedback residual over the data axis: the port's own
copy of the part of the JAX package's ``parallel/sharding.py`` this slice
needs.

* The rule table (``RULES``): each parameter's partition spec in the JSON
  form the checkpoint manifests use (``None``, an axis name, or a list of
  names a dimension), looked up by the innermost key of a leaf path
  (`spec_for_manifest_path`).
* `zero1_leaf_spec`: a moment leaf's spec under ``--optimizer-sharding
  zero1``, the rule with the data axis appended to the first dimension the
  data width divides (JAX ``:139-162``); `grad_residual_spec`: the
  ``(replicas, L)`` residual with its first dimension on the data axis.

The port's leaves stay whole tensors on every rank. These specs say which
slice of a leaf a rank owns (`LeafShard`): its 1/dp of each zero1 moment
leaf, its row of the residual. `zero1_layout` lays that out over a model;
`allgather_leaf` brings every rank's updated slice of a parameter leaf to
every rank, and `gather_leaf` / `scatter_leaf` turn a rank's slice into the
whole leaf and back for the engines that write and read whole leaves.
"""

import dataclasses

import torch

AXIS_DATA = "data"

# the innermost leaf key -> its partition spec (JAX ``_RULES``, JSON form)
RULES = {
    "tok_embed": [None, ["tensor", "fsdp"]],
    "wq": ["pipeline", "fsdp", "tensor"],
    "wk": ["pipeline", "fsdp", "tensor"],
    "wv": ["pipeline", "fsdp", "tensor"],
    "wo": ["pipeline", "tensor", "fsdp"],
    "w1": ["pipeline", "fsdp", "tensor"],
    "w3": ["pipeline", "fsdp", "tensor"],
    "w2": ["pipeline", "tensor", "fsdp"],
    "router": ["pipeline", None, None],
    "moe_w1": ["pipeline", "expert", "fsdp", "tensor"],
    "moe_w3": ["pipeline", "expert", "fsdp", "tensor"],
    "moe_w2": ["pipeline", "expert", "tensor", "fsdp"],
    "attn_norm": ["pipeline", None],
    "ffn_norm": ["pipeline", None],
    "final_norm": [None],
    "output": ["fsdp", "tensor"],
}


def path_keys(path):
    """The dict keys of a leaf path, in order (``.opt_state[1][0].mu['layers']
    ['wq']`` -> ``['layers', 'wq']``)."""
    return [part.split("']")[0] for part in path.split("['")[1:]]


def spec_for_manifest_path(path, ndim):
    """A manifest leaf path's spec: the residual's, else the rule of its
    innermost key that has one, else replicated (also when the rule's rank
    is not the leaf's)."""
    if path.startswith(".grad_residual"):
        return grad_residual_spec(ndim)
    for key in reversed(path_keys(path)):
        rule = RULES.get(key)
        if rule is not None:
            return list(rule) if len(rule) == ndim else [None] * ndim
    return [None] * ndim


def _entries(spec, ndim):
    out = [() if e is None else tuple(e) if isinstance(e, list) else (e,) for e in spec]
    return out + [()] * (ndim - len(out))


def zero1_leaf_spec(rule, shape, mesh_shape):
    """The zero1 spec of a moment leaf: ``rule`` with the data axis appended
    to the first dimension that the product of its axes and the data width
    divides; ``rule`` unchanged when none does, when the data axis is
    trivial or when the rule already names it."""
    data = int(mesh_shape.get(AXIS_DATA, 1))
    if rule is None:
        rule = [None] * len(shape)
    if data <= 1:
        return list(rule)
    entries = _entries(rule, len(shape))
    if any(AXIS_DATA in e for e in entries):
        return list(rule)
    for dim, axes in enumerate(entries):
        factor = 1
        for a in axes:
            factor *= int(mesh_shape.get(a, 1))
        if shape[dim] % (factor * data) == 0:
            entries[dim] = axes + (AXIS_DATA,)
            return [None if not e else e[0] if len(e) == 1 else list(e) for e in entries]
    return list(rule)


def grad_residual_spec(ndim=2):
    """The residual's spec: its replica dimension on the data axis."""
    return [AXIS_DATA] + [None] * (ndim - 1)


def data_dim(spec):
    """The dimension a JSON spec puts the data axis on, or None."""
    for dim, e in enumerate(spec or []):
        if e == AXIS_DATA or (isinstance(e, list) and AXIS_DATA in e):
            return dim
    return None


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """A rank's slice of a leaf of ``shape``: piece ``index`` of ``count``
    along ``dim``. ``stacked``: the leaf is layer tensors stacked on dim 0
    (each a part), so dim 0 picks whole parts and a later dim slices each."""

    dim: int
    index: int
    count: int
    shape: tuple
    stacked: bool = False

    @property
    def size(self):
        return self.shape[self.dim] // self.count

    @property
    def local_shape(self):
        return tuple(self.size if d == self.dim else s for d, s in enumerate(self.shape))

    def part_region(self, i):
        """Part ``i``'s owned region, ``(dim, start, length)`` of the part,
        or None when this rank owns none of it."""
        lo = self.index * self.size
        if self.stacked and self.dim == 0:
            return (0, 0, self.shape[1]) if lo <= i < lo + self.size else None
        return (self.dim - 1 if self.stacked else self.dim, lo, self.size)


def owned(tensor, region):
    """The view of ``tensor`` a ``(dim, start, length)`` region names."""
    dim, start, length = region
    return tensor.narrow(dim, start, length)


def zero1_layout(model, world, rank):
    """``{leaf path: (LeafShard or None, zero1 JSON spec)}`` over the model's
    ``.params`` leaves (paths without the ``.params`` prefix): None where no
    dimension divides (the leaf's moments stay whole on every rank)."""
    from pyrecover_tpu_torch.train_state import param_leaves

    mesh_shape = {AXIS_DATA: int(world)}
    out = {}
    for leaf in param_leaves(model):
        path = leaf.path[len(".params"):]
        spec = zero1_leaf_spec(spec_for_manifest_path(path, len(leaf.shape)), leaf.shape,
                               mesh_shape)
        dim = data_dim(spec)
        shard = None
        if dim is not None:
            shard = LeafShard(dim, int(rank), int(world), tuple(leaf.shape),
                              stacked=path.startswith("['layers']"))
        out[path] = (shard, spec)
    return out


def _local(shard, parts):
    """A rank's slice of a leaf from its whole parts, as one tensor of the
    slice's shape."""
    regions = [shard.part_region(i) for i in range(len(parts))]
    pieces = [owned(p, r) for p, r in zip(parts, regions) if r is not None]
    if shard.stacked:
        return torch.stack(pieces)
    return pieces[0].contiguous()


def allgather_leaf(shard, parts):
    """After each rank updated its slice of the parameter leaf ``parts`` in
    place: every rank's slice into every rank's parts."""
    from pyrecover_tpu_torch.parallel.collectives import all_gather_rows

    full = torch.cat(list(all_gather_rows(_local(shard, parts)).unbind(0)), shard.dim)
    with torch.no_grad():
        if shard.stacked:
            for part, src in zip(parts, full.unbind(0)):
                part.copy_(src)
        else:
            parts[0].copy_(full)


def gather_leaf(shard, local_parts):
    """The whole leaf, on the parts' device, from each rank's ``local_parts``
    (its slice's bytes in C order, as a sharded `Leaf` holds them)."""
    from pyrecover_tpu_torch.parallel.collectives import all_gather_rows

    local = torch.cat([p.reshape(-1) for p in local_parts]).reshape(shard.local_shape)
    return torch.cat(list(all_gather_rows(local).unbind(0)), shard.dim)


def scatter_leaf(shard, full, local_parts):
    """Copy this rank's slice of the whole leaf ``full`` into
    ``local_parts``."""
    flat = full.narrow(shard.dim, shard.index * shard.size, shard.size).reshape(-1)
    off = 0
    with torch.no_grad():
        for part in local_parts:
            n = part.numel()
            part.copy_(flat[off:off + n].reshape(part.shape))
            off += n
