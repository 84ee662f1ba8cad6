"""Partition rules and the slices they give each rank: the port's own copy
of the JAX package's ``parallel/sharding.py``, over the data, fsdp, tensor,
expert and pipeline axes (the sequence axis splits activations only).

* The rule table (``RULES``): each parameter's partition spec in the JSON
  form the checkpoint manifests use (``None``, an axis name, or a list of
  names a dimension), looked up by the innermost key of a leaf path
  (`spec_for_manifest_path`). JAX's batch spec, ``P((data, fsdp),
  sequence)``, is the mesh's ``batch_index`` (``parallel/mesh.py``): the
  data x fsdp ranks hold other rows, tensor and expert peers the same.
* `zero1_leaf_spec`: a moment leaf's spec under ``--optimizer-sharding
  zero1``, the rule with the data axis appended to the first dimension the
  product of its axes and the data width divides (JAX ``:139-162``);
  `grad_residual_spec`: the ``(replicas, L)`` residual with its first
  dimension on the data axis.

A spec and a rank's mesh coordinates give the rank's box of a leaf
(`leaf_box`): a dimension split over several axes is indexed in their
order, the first major (``tok_embed``'s model dimension over ``(tensor,
fsdp)`` puts rank ``(t, f)`` at piece ``t * fsdp + f``). `LeafShard` is a
leaf of which each rank holds its box; `shard_model` leaves a model with
this rank's boxes under the rules: its own slice for the tensor and expert
axes (an MoE block's ``moe_w*`` leaves hold ``E / ep`` experts, each cut on
F over tensor), FSDP2's ``fully_shard`` for the fsdp axis (whose local
shards are those boxes, `local_tensor`); `zero1_layout` lays the ZeRO-1
moments out within them. Over the pipeline axis a stage holds the layers
`stage_layers` gives it (a stacked leaf's ``layer_ids``: contiguous, or at
``pp_virtual_stages`` V above 1 its V chunks ``j * S + s``, as JAX's
``interleave_layer_chunks`` hands them out), and the model keeps only those
blocks. `allgather_leaf` brings every data rank's updated slice of a parameter
to every data rank, and `gather_leaf` / `scatter_leaf` turn a rank's slice
into the whole leaf and back for the engines that write and read whole
leaves.
"""

import dataclasses
import sys

import torch

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_EXPERT = "expert"
AXIS_PIPE = "pipeline"

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


def entries(spec, ndim):
    """A JSON spec as one tuple of axis names a dimension, ``ndim`` long."""
    out = [() if e is None else tuple(e) if isinstance(e, list) else (e,) for e in spec or []]
    return out + [()] * (ndim - len(out))


def _entries_to_spec(ents):
    return [None if not e else e[0] if len(e) == 1 else list(e) for e in ents]


def shard_factor(spec, ndim, mesh_shape):
    """The pieces a spec cuts each dimension into on ``mesh_shape``."""
    out = []
    for axes in entries(spec, ndim):
        n = 1
        for a in axes:
            n *= int(mesh_shape.get(a, 1))
        out.append(n)
    return out


def leaf_box(spec, shape, mesh_shape, coords):
    """The ``((start, length), ...)`` of ``shape`` that the rank at
    ``coords`` holds under ``spec`` on ``mesh_shape``. A dimension over
    several axes is indexed in their order, the first major. Raises
    ``ValueError`` where the pieces do not divide a dimension."""
    box = []
    for dim, axes in enumerate(entries(spec, len(shape))):
        index, count = 0, 1
        for a in axes:
            n = int(mesh_shape.get(a, 1))
            index, count = index * n + int(coords.get(a, 0)), count * n
        if shape[dim] % count:
            raise ValueError(f"dimension {dim} of {tuple(shape)} is not divisible by the "
                             f"{count} pieces of spec {spec} on mesh {mesh_shape}")
        length = shape[dim] // count
        box.append((index * length, length))
    return tuple(box)


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
    ents = entries(rule, len(shape))
    if any(AXIS_DATA in e for e in ents):
        return list(rule)
    for dim, axes in enumerate(ents):
        factor = 1
        for a in axes:
            factor *= int(mesh_shape.get(a, 1))
        if shape[dim] % (factor * data) == 0:
            ents[dim] = axes + (AXIS_DATA,)
            return _entries_to_spec(ents)
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


def stage_layers(n_layers, stages, virtual, stage):
    """The layers pipeline stage ``stage`` of ``stages`` holds, ascending:
    ``n_layers / stages`` contiguous ones, or at ``virtual`` V above 1 its V
    chunks of ``n_layers / (stages * V)`` layers, chunk ``j`` being logical
    stage ``j * stages + stage`` (JAX's ``interleave_layer_chunks``)."""
    cl = n_layers // (stages * virtual)
    return tuple((j * stages + stage) * cl + c for j in range(virtual) for c in range(cl))


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """A leaf of ``shape`` of which this rank holds ``box`` (``(start,
    length)`` a dimension), and the ranks of ``group`` (None: the default
    group) hold ``boxes``, in the group's rank order. ``stacked``: the leaf
    is layer tensors stacked on dim 0 (each a part), so dim 0 picks whole
    parts and the later dimensions slice each. Over a pipeline axis a
    stacked leaf's parts are this stage's layers only: ``layer_ids`` (their
    indices along dim 0, ascending) and ``rank_layer_ids`` (every rank's)
    then say which, in place of the boxes' dim 0."""

    shape: tuple
    box: tuple
    boxes: tuple
    group: object = None
    stacked: bool = False
    layer_ids: tuple = None
    rank_layer_ids: tuple = None

    @classmethod
    def along(cls, dim, index, count, shape, stacked=False, group=None):
        """Piece ``index`` of ``count`` along ``dim``, rank i of the group
        holding piece i."""
        shape = tuple(shape)
        size = shape[dim] // count

        def box(i):
            return tuple((i * size, size) if d == dim else (0, n) for d, n in enumerate(shape))

        return cls(shape, box(index), tuple(box(i) for i in range(count)), group, stacked)

    @classmethod
    def of_spec(cls, spec, shape, mesh_shape, rank, stacked=False, virtual=1):
        """The slices ``spec`` gives every rank of the mesh (the default
        group), this one at ``rank``; a stacked leaf the spec splits over
        the pipeline axis holds `stage_layers` (``virtual`` chunks a
        stage), and where the spec splits that dimension over more axes
        after the pipeline (ZeRO-1's data axis, `zero1_leaf_spec`) their
        piece of the stage's layers, in their order."""
        from pyrecover_tpu_torch.parallel.mesh import coords_of, mesh_size

        ranks = range(mesh_size(mesh_shape))
        boxes = tuple(leaf_box(spec, shape, mesh_shape, coords_of(r, mesh_shape))
                      for r in ranks)
        stages = int(mesh_shape.get(AXIS_PIPE, 1))
        dim0 = entries(spec, len(shape))[0]
        if not (stacked and stages > 1 and AXIS_PIPE in dim0):
            return cls(tuple(shape), boxes[int(rank)], boxes, None, stacked)

        def layers(r):
            coords = coords_of(r, mesh_shape)
            ids = stage_layers(shape[0], stages, virtual, coords[AXIS_PIPE])
            index, count = 0, 1
            for a in dim0[dim0.index(AXIS_PIPE) + 1:]:
                n = int(mesh_shape.get(a, 1))
                index, count = index * n + int(coords.get(a, 0)), count * n
            k = len(ids) // count
            return ids[index * k:(index + 1) * k]

        ids = tuple(layers(r) for r in ranks)
        return cls(tuple(shape), boxes[int(rank)], boxes, None, stacked, ids[int(rank)], ids)

    @property
    def local_shape(self):
        return tuple(length for _, length in self.box)

    def part_region(self, i):
        """Part ``i``'s owned region, ``((start, length), ...)`` over the
        part's dimensions, or None when this rank owns none of it."""
        if not self.stacked:
            return self.box
        if self.layer_ids is not None:
            return self.box[1:] if i in self.layer_ids else None
        start, length = self.box[0]
        return self.box[1:] if start <= i < start + length else None


def owned(tensor, region):
    """The view of ``tensor`` that a region (``(start, length)`` a
    dimension) names."""
    for dim, (start, length) in enumerate(region):
        if start or length != tensor.shape[dim]:
            tensor = tensor.narrow(dim, start, length)
    return tensor


def assemble(pieces, boxes, shape, origin=None):
    """One tensor of ``shape`` (at ``origin``, default 0 a dimension) from
    ``pieces`` (a tensor of shape (n, ...) or a list) placed at their
    ``boxes``; pieces that repeat a box (replicas) write the same bytes."""
    origin = origin or (0,) * len(shape)
    out = pieces[0].new_empty(shape)
    for piece, box in zip(pieces, boxes):
        view = out
        for dim, ((start, length), o) in enumerate(zip(box, origin)):
            view = view.narrow(dim, start - o, length)
        view.copy_(piece.reshape(view.shape))
    return out


def _local(shard, parts):
    """A rank's slice of a leaf from its parts (whole parts, narrowed to the
    owned region), as one tensor of the slice's shape."""
    regions = [shard.part_region(i) for i in range(len(parts))]
    pieces = [owned(p, r) for p, r in zip(parts, regions) if r is not None]
    if shard.stacked:
        return torch.stack(pieces)
    return pieces[0].contiguous()


def _gathered(shard, local, origin=None, shape=None):
    from pyrecover_tpu_torch.parallel.collectives import all_gather_rows

    return assemble(all_gather_rows(local, shard.group), shard.boxes, shape or shard.shape,
                    origin)


def allgather_leaf(shard, parts):
    """After each rank of the shard's group updated its region of the
    parameter leaf ``parts`` in place: every rank's region into every rank's
    parts. ``shard.shape`` is the shape the parts make together."""
    full = _gathered(shard, _local(shard, parts))
    with torch.no_grad():
        if shard.stacked:
            for part, src in zip(parts, full.unbind(0)):
                part.copy_(src)
        else:
            parts[0].copy_(full)


def _by_layer(shard):
    """The boxes of ``shard`` with dim 0 one layer a row: ``(boxes, origin
    rows)`` over the per-rank layer lists (a pipeline-split stacked leaf)."""
    boxes = []
    for ids, box in zip(shard.rank_layer_ids, shard.boxes):
        boxes.extend(((i, 1),) + tuple(box[1:]) for i in ids)
    return boxes


def gather_leaf(shard, local_parts):
    """The whole leaf, on the parts' device, from each rank's ``local_parts``
    (its slice's bytes in C order, as a sharded `Leaf` holds them)."""
    with torch.no_grad():
        local = torch.cat([p.detach().reshape(-1) for p in local_parts])
        if shard.layer_ids is None:
            return _gathered(shard, local.reshape(shard.local_shape))
        from pyrecover_tpu_torch.parallel.collectives import all_gather_rows

        rows = all_gather_rows(local.reshape(shard.local_shape), shard.group)
        pieces = [layer for r in rows for layer in r.unbind(0)]
        return assemble(pieces, _by_layer(shard), shard.shape)


def scatter_leaf(shard, full, local_parts):
    """Copy this rank's slice of the whole leaf ``full`` into
    ``local_parts``."""
    if shard.layer_ids is not None:
        full = full[list(shard.layer_ids)]
        flat = owned(full, ((0, full.shape[0]),) + tuple(shard.box[1:])).reshape(-1)
    else:
        flat = owned(full, shard.box).reshape(-1)
    off = 0
    with torch.no_grad():
        for part in local_parts:
            n = part.numel()
            part.copy_(flat[off:off + n].reshape(part.shape))
            off += n


# ---- a serving model's boxes: cut once, no training hooks -------------------------

# the axes a serving block's own collectives run over (the tensor pair, the
# expert x tensor sum); fsdp slices are gathered before a block runs
BLOCK_AXES = (AXIS_TENSOR, AXIS_EXPERT)


def part_spec(path, ndim, stacked):
    """The rule of one part of a ``.params`` leaf: a stacked leaf's part
    (one layer's tensor) drops the rule's layer dimension."""
    spec = spec_for_manifest_path(path, ndim + int(stacked))
    return spec[1:] if stacked else spec


def box_shape(path, shape, mesh, stacked):
    """The shape of this rank's box of a part of ``shape`` under the rules
    on ``mesh`` (a `DeviceMesh`). Raises ``ValueError`` where the pieces do
    not divide a dimension."""
    box = leaf_box(part_spec(path, len(shape), stacked), shape, mesh.shape, mesh.coords)
    return tuple(length for _, length in box)


def held_rows(leaf):
    """``(first, count)`` of the layer rows this rank holds of a stacked
    leaf split over the pipeline axis (a stage's contiguous layers), or
    None when it reads the whole leaf."""
    shard = leaf.shard
    if shard is None or shard.layer_ids is None:
        return None
    ids = shard.layer_ids
    if list(ids) != list(range(ids[0], ids[0] + len(ids))):
        return None
    return ids[0], len(ids)


def place_leaf(leaf, whole, rows=None):
    """Copy this rank's box of a leaf into its parts: ``whole`` is the whole
    leaf (a host tensor of ``leaf.shape``) or, with ``rows`` (`held_rows`),
    only those layer rows of it. The copy casts to the parts' dtype and
    moves to their device; a box is cut on the host, so no whole leaf ever
    reaches the card."""
    shard = leaf.shard
    with torch.no_grad():
        if shard is None:
            if len(leaf.parts) == 1 and tuple(leaf.parts[0].shape) == tuple(whole.shape):
                leaf.parts[0].copy_(whole)
            else:
                for part, src in zip(leaf.parts, whole.unbind(0)):
                    part.copy_(src)
        elif rows is not None:
            for part, src in zip(leaf.parts, whole.unbind(0)):
                part.copy_(owned(src, shard.box[1:]))
        else:
            scatter_leaf(shard, whole, leaf.parts)


def block_weights(module, mesh, keys=None):
    """``module``'s parameters (of ``keys``, default all) whole over the
    fsdp axis, for one forward: each leaf the rules split over fsdp
    gathered along its fsdp dimension (within a dimension split over
    tensor and fsdp, the fsdp pieces of this rank's tensor piece, so the
    tensor split stays), the others as they are. Returns ``module`` itself
    without an fsdp axis, else a namespace with the parameters, the
    module's ``tensor_group``, ``mesh`` and ``config``, which the
    forward's helpers read as they read a module; it is dropped after the
    step."""
    import types

    from pyrecover_tpu_torch.parallel.collectives import tensor_gather

    if mesh is None or mesh.shape.get(AXIS_FSDP, 1) == 1:
        return module
    group = mesh.group(AXIS_FSDP)
    stacked = not hasattr(module, "layers")
    out = {}
    for name, p in module.named_parameters(recurse=False):
        if keys is not None and name not in keys:
            continue
        path = f".params['layers']['{name}']" if stacked else f".params['{name}']"
        dims = [d for d, axes in enumerate(entries(part_spec(path, p.dim(), stacked), p.dim()))
                if AXIS_FSDP in axes]
        out[name] = tensor_gather(p, dims[0], group) if dims else p
    for attr in ("tensor_group", "mesh", "config"):
        if hasattr(module, attr):
            out[attr] = getattr(module, attr)
    return types.SimpleNamespace(**out)


def serving_shard(model, mesh):
    """Hang ``mesh`` (a `DeviceMesh`) on a serving model whose parameters
    are already this rank's boxes: the model keeps the mesh (its leaves'
    boxes, `train_state.param_leaves`) and the tensor group, each block the
    tensor group and a view of the mesh over `BLOCK_AXES` (data, fsdp,
    sequence and pipeline ranks hold whole rows, so a block's MoE routes
    each row whole, as one device does)."""
    group = mesh.group(AXIS_TENSOR)
    block_mesh = mesh.view(BLOCK_AXES)
    model.mesh = mesh
    model.tensor_group = group
    for layer in model.layers:
        layer.tensor_group = group
        layer.mesh = block_mesh
    return model


# ---- the model under fsdp, tensor and expert ------------------------------------


def param_shard(path, shape, mesh, stacked):
    """The `LeafShard` of a ``.params`` leaf on ``mesh`` (a `DeviceMesh`),
    or None when this mesh keeps it whole on every rank."""
    spec = spec_for_manifest_path(path, len(shape))
    if all(n == 1 for n in shard_factor(spec, len(shape), mesh.shape)):
        return None
    return LeafShard.of_spec(spec, shape, mesh.shape, mesh.rank, stacked=stacked)


def local_tensor(t):
    """This rank's shard of a DTensor (an FSDP2 parameter or its gradient),
    the same tensor object at every call; any other tensor itself. No
    DTensor exists before its module is imported, and a run without fsdp
    does not pay that import (a second a process); nor before the class is
    defined, while another thread is still importing the module."""
    cls = getattr(sys.modules.get("torch.distributed.tensor"), "DTensor", None)
    return t._local_tensor if cls is not None and isinstance(t, cls) else t


def reshard(model):
    """Drop what FSDP2 gathered for a forward that no backward follows (an
    eval): it keeps the model's own weights, and a block's without remat,
    until their backward, while the optimizer and the checkpoint leaves
    (`local_tensor`) read the shards."""
    from torch.distributed.fsdp import FSDPModule

    for module in model.modules():
        if isinstance(module, FSDPModule):
            module.reshard()


def shard_model(model, mesh):
    """Leave this rank's box of every parameter under the rules (JAX
    ``shard_params``) and hang ``mesh`` on the model and each block. The
    tensor and expert axes: each leaf they split is cut to this rank's
    piece here, and the tensor group hangs on the model and its blocks as
    ``tensor_group`` (Megatron's column/row split, ``models/llama.py``; an
    MoE block's FFN sums its partial outputs over the ``expert_tensor``
    group instead, ``models/moe.py``). The fsdp axis: each block, then
    the model, is ``fully_shard``-ed over the fsdp group, every leaf on the
    dimension its rule gives fsdp (tensor-major within a dimension both
    split, as the rules order them); the leaves it does not split (the
    norms) stay whole and out of FSDP2, and the step sums their gradients.
    FSDP2 gathers in the compute dtype and reduce-scatters sums in the
    parameter dtype. A block's gathered weights are dropped after its
    forward only under remat, whose backward reruns the block: JAX's
    schedule, a gather before use in the forward and again in the backward
    under remat."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor import Shard

    from pyrecover_tpu_torch.parallel.mesh import DeviceMesh
    from pyrecover_tpu_torch.train_state import param_leaves
    from pyrecover_tpu_torch.utils.dtypes import resolve_dtype

    stages = mesh.shape.get(AXIS_PIPE, 1)
    if stages > 1:
        # this stage's blocks only (the seeded whole model's, so any mesh
        # starts from the same weights); the embedding, the final norm and
        # the output stay whole on every stage
        cfg = model.config
        ids = stage_layers(cfg.n_layers, stages, cfg.pp_virtual_stages,
                           mesh.coords[AXIS_PIPE])
        model.layers = torch.nn.ModuleList(model.layers[i] for i in ids)
        model.stage_layer_ids = ids
    # the tensor x expert sub-mesh (expert innermost): the slices cut here
    local_shape = {a: mesh.shape[a] for a in (AXIS_TENSOR, AXIS_EXPERT)}
    local_mesh = DeviceMesh(local_shape, mesh.coords[AXIS_TENSOR] * mesh.shape[AXIS_EXPERT]
                            + mesh.coords[AXIS_EXPERT])
    placements, whole = {}, set()
    for leaf in param_leaves(model):
        stacked = leaf.path.startswith(".params['layers']")
        key = path_keys(leaf.path)[-1]
        owners = list(model.layers) if stacked else [model]
        spec = spec_for_manifest_path(leaf.path, len(leaf.shape))
        fsdp_dims = [d for d, axes in enumerate(entries(spec, len(leaf.shape)))
                     if AXIS_FSDP in axes]
        shard = param_shard(leaf.path, leaf.shape, local_mesh, stacked)
        for i, (owner, part) in enumerate(zip(owners, leaf.parts)):
            if shard is not None:
                local = owned(part.detach(), shard.part_region(i)).clone()
                part = torch.nn.Parameter(local, requires_grad=part.requires_grad)
                setattr(owner, key, part)
            if fsdp_dims:
                placements[part] = Shard(fsdp_dims[0] - int(stacked))
            else:
                whole.add(part)
    group = mesh.group(AXIS_TENSOR)
    model.tensor_group = group
    for layer in model.layers:
        layer.tensor_group = group
        layer.mesh = mesh
    if mesh.shape[AXIS_FSDP] > 1:
        from torch.distributed.device_mesh import DeviceMesh as TorchMesh

        device = next(model.parameters()).device
        fsdp_mesh = TorchMesh.from_group(mesh.group(AXIS_FSDP), device.type)
        cfg = model.config
        policy = MixedPrecisionPolicy(param_dtype=resolve_dtype(cfg.compute_dtype),
                                      reduce_dtype=resolve_dtype(cfg.param_dtype),
                                      cast_forward_inputs=False)
        kw = dict(mesh=fsdp_mesh, shard_placement_fn=placements.get, mp_policy=policy,
                  ignored_params=whole)
        for layer in model.layers:
            fully_shard(layer, reshard_after_forward=bool(cfg.remat), **kw)
        fully_shard(model, **kw)
        for module in (*model.layers, model):
            # JAX's sum over the batch shards, not FSDP2's mean; gloo has no
            # pre-scaled sum
            module.set_gradient_divide_factor(1.0)
            module.set_force_sum_reduction_for_comms(True)
    model.mesh = mesh
    return model


def zero1_layout(model, mesh):
    """``{leaf path: (moment LeafShard or None, zero1 JSON spec, update
    LeafShard or None)}`` over the model's ``.params`` leaves (paths without
    the ``.params`` prefix) on ``mesh`` (a `DeviceMesh`). The moment shard is
    the rank's box of the whole moment leaf (None: the moments are the
    parameter's own slices, no data axis divides the leaf); the update shard
    is that box within the rank's parameter parts, over the data group,
    whose ranks update the other boxes and gather them back. Over a
    pipeline axis the data axis folds into the layer dimension after it
    (JAX's ``P(("pipeline", "data"), ...)``): a data rank's moments are its
    piece of its stage's layers, and its update box is that piece of the
    stage's parts."""
    from pyrecover_tpu_torch.parallel.mesh import coords_of, group_ranks
    from pyrecover_tpu_torch.train_state import param_leaves

    out = {}
    data_ranks = group_ranks(AXIS_DATA, mesh.rank, mesh.shape)
    for leaf in param_leaves(model):
        path = leaf.path[len(".params"):]
        shape = tuple(leaf.shape)
        rule = spec_for_manifest_path(path, len(shape))
        spec = zero1_leaf_spec(rule, shape, mesh.shape)
        stacked = path.startswith("['layers']")
        if data_dim(spec) is None:
            out[path] = (None, spec, None)
            continue
        moment = LeafShard.of_spec(spec, shape, mesh.shape, mesh.rank, stacked=stacked,
                                   virtual=model.config.pp_virtual_stages)
        pbox = leaf_box(rule, shape, mesh.shape, mesh.coords)
        local_shape = tuple(n for _, n in pbox)

        def rel(r):
            zbox = leaf_box(spec, shape, mesh.shape, coords_of(r, mesh.shape))
            return tuple((zs - ps, zl) for (zs, zl), (ps, _) in zip(zbox, pbox))

        update = LeafShard(local_shape, rel(mesh.rank), tuple(rel(r) for r in data_ranks),
                           mesh.group(AXIS_DATA), stacked)
        out[path] = (moment, spec, update)
    return out
