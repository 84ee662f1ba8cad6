"""Optimizer and LR schedules, matching the JAX package's optax chain.

``build_optimizer`` gives global-norm clipping followed by AdamW, computed
as optax computes them (``torch.optim.AdamW`` and ``clip_grad_norm_`` follow
other trajectories):

* clipping scales every gradient by ``max_norm / norm`` only when
  ``norm >= max_norm`` (optax.clip_by_global_norm; no epsilon);
* AdamW is optax.adamw: bias-corrected moments, eps 1e-8 added outside
  the square root, then decoupled weight decay on every parameter (no
  mask), then ``-lr``;
* the learning rate of an update is the schedule at the number of updates
  made BEFORE it (0 for the first);
* the moments ``mu`` and ``nu`` are kept in the parameter dtype, as
  optax.adamw without ``mu_dtype`` keeps them, leaf by leaf: a tree that
  mixes dtypes (an MoE model's fp32 router beside bf16 parameters) updates
  each leaf in its own dtype, and the clip divides each leaf by the global
  norm cast to that leaf's dtype, the norm itself in JAX's promotion of the
  leaves' dtypes (fp32 once any leaf is fp32), as optax does. With fp32
  parameters the update is computed in fp32; with bf16 (or fp16) parameters every
  operation of optax's chain (``clip_by_global_norm`` ->
  ``scale_by_adam`` -> ``add_decayed_weights`` -> ``scale_by_learning_rate``
  -> ``apply_updates``) runs in that dtype, in optax's order, with its
  Python constants rounded to it as JAX's weak types round them, so each
  value rounds where optax rounds it.

ZeRO-1 (``--optimizer-sharding zero1``, `OptaxAdamW.shard_moments`): the
clip's norm is taken over the whole synced gradient as before; then each
rank updates only its slice of every parameter leaf that the data width
divides (``parallel/sharding.py::zero1_leaf_spec``), with moments it holds
for that slice alone, and the updated slices are all-gathered into every
data rank's parameters. Each element's arithmetic is the replicated update's, so
zero1 at fp32 is bit-equal to ``none`` (the JAX package's contract).

On an fsdp, tensor or expert mesh the parameters, their gradients and
moments are this rank's slices, and AdamW runs on them (JAX
``optim.py:187-191``); the clip's global norm is the norm of the whole
gradient (`set_norm_mesh`: local sums of squares, each expert slice and
each replicated leaf counted on one rank of the model group, summed over
that group). ZeRO-1 then slices each local parameter once more over the
data axis, as JAX's ``zero1_leaf_spec`` does with fsdp.
"""

import math

import torch

from pyrecover_tpu_torch.train_state import global_norm


def _linear(init_value, end_value, transition_steps):
    """optax.linear_schedule (transition_begin 0)."""

    def schedule(step):
        if transition_steps <= 0:
            return init_value
        frac = 1.0 - min(max(step, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _join(schedules, boundaries):
    """optax.join_schedules: schedule i runs from boundary i-1, with its
    step counted from there."""

    def schedule(step):
        start = 0
        for fn, boundary in zip(schedules, boundaries):
            if step < boundary:
                return fn(step - start)
            start = boundary
        return schedules[-1](step - start)

    return schedule


def warmup_constant_schedule(base_lr, warmup_steps):
    """Linear warmup from base_lr / warmup_steps to base_lr, then constant:
    factor min(1, (step + 1) / warmup_steps), as the reference's scheduler."""
    boundary = max(warmup_steps - 1, 1)
    return _join(
        [_linear(base_lr / max(warmup_steps, 1), base_lr, boundary),
         lambda step: base_lr],
        [boundary],
    )


def warmup_cosine_schedule(base_lr, warmup_steps, total_steps, min_ratio=0.1):
    """optax.warmup_cosine_decay_schedule: linear warmup, then cosine decay
    to ``min_ratio * base_lr`` at ``total_steps``."""
    warmup = max(warmup_steps, 1)
    decay_steps = max(total_steps, warmup_steps + 1) - warmup
    alpha = min_ratio

    def cosine(step):
        if decay_steps <= 0:
            return base_lr
        count = min(step, decay_steps)
        decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay_steps)) + alpha
        return base_lr * decayed

    return _join([_linear(base_lr / warmup, base_lr, warmup), cosine], [warmup])


def _rounded(x, dtype):
    """The Python scalar ``x`` rounded to ``dtype`` (via fp32, as an fp32
    value such as a schedule's learning rate reaches a bf16 update)."""
    return torch.tensor(x, dtype=torch.float32).to(dtype).item()


def _norm_dtype(grads):
    """The dtype of optax.global_norm over leaves of these dtypes: JAX's
    promotion of their per-leaf sums. A tree of one low dtype (bf16
    parameters) keeps it; any mix (an MoE model's fp32 router beside bf16
    parameters) promotes to fp32."""
    dtypes = {g.dtype for g in grads}
    return dtypes.pop() if len(dtypes) == 1 else torch.float32


def _adam_low_precision(p, g, mu, nu, lr, b1, b2, eps, wd, t):
    """optax.adamw's update of ``p`` in place, every operation in
    ``p.dtype`` (bf16/fp16) as optax computes it there: moments
    ``(1 - b) g^k + b m``, bias corrections ``1 - b^t`` taken in fp32 and
    cast, ``m_hat / (sqrt(v_hat) + eps)``, ``+ wd p``, ``* -lr``, ``p + u``."""
    dt = p.dtype
    mu.mul_(_rounded(b1, dt)).add_(g * _rounded(1 - b1, dt))
    nu.mul_(_rounded(b2, dt)).add_((g * g).mul_(_rounded(1 - b2, dt)))
    c1, c2 = (1 - torch.tensor(b, dtype=torch.float32) ** torch.tensor(float(t))
              for b in (b1, b2))
    update = (mu / c1.to(dt)) / ((nu / c2.to(dt)).sqrt_().add_(_rounded(eps, dt)))
    update.add_(p * _rounded(wd, dt)).mul_(_rounded(-lr, dt))
    p.add_(update)


class OptaxAdamW(torch.optim.Optimizer):
    """Global-norm clipping (``max_norm`` > 0) + optax.adamw, applied in
    place. ``lr`` is a schedule: a function of the update count."""

    def __init__(self, params, lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 max_norm=0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.max_norm = float(max_norm)
        self.count = 0  # updates made so far (optax's schedule count)
        # ZeRO-1 (`shard_moments`): leaf path -> (moment LeafShard or None,
        # spec), each parameter's owned region (absent: the whole tensor;
        # None: not this rank's), and the leaves whose slices are gathered
        # after a step (their update LeafShard and parts)
        self.zero1 = {}
        self.regions = {}
        self.zero1_leaves = []
        # the global norm over a mesh's slices (`set_norm_mesh`), and the
        # norm the last step took (before its clip)
        self.norm_group = self.norm_owners = None
        self.last_grad_norm = None

    def shard_moments(self, model, mesh):
        """ZeRO-1 over ``mesh``'s data axis (a `DeviceMesh`): from now on
        this rank keeps moments
        for, and updates, only its slice of each parameter leaf of ``model``
        that the data width divides (the others stay whole on every data
        rank), and a step ends by all-gathering the updated slices over the
        data group. Call before the first step."""
        from pyrecover_tpu_torch.parallel.sharding import zero1_layout
        from pyrecover_tpu_torch.train_state import param_leaves

        if self.count or self.state:
            raise RuntimeError("shard_moments must come before the first update")
        layout = zero1_layout(model, mesh)
        for leaf in param_leaves(model):
            moment, spec, update = layout[leaf.path[len(".params"):]]
            self.zero1[leaf.path] = (moment, spec)
            if update is None:
                continue
            self.zero1_leaves.append((update, leaf.parts))
            for i, p in enumerate(leaf.parts):
                self.regions[p] = update.part_region(i)

    def set_norm_mesh(self, group, owners):
        """Take the clip's global norm over a mesh's slices: each parameter
        ``p`` adds its gradient's sum of squares where ``owners[p]``, and the
        sums add up over ``group`` (None: this rank holds the whole model)."""
        self.norm_group, self.norm_owners = group, owners

    def grad_norm(self, grads):
        """The global norm of the gradient ``grads`` (``{parameter:
        gradient}``), fp32. A rank that owns none of the elements (a
        sequence rank past 0 of a model every sequence rank holds whole)
        adds a zero on the gradients' device: over a group of two backends
        the tensor's device picks the backend, and a host zero would meet
        its peers' device sums in another collective, which never ends."""
        if self.norm_owners is None:
            return global_norm(grads.values())
        import torch.distributed as dist

        sq = [torch.sum(g.float() * g.float()) for p, g in grads.items()
              if self.norm_owners.get(p, True)]
        device = next(iter(grads.values())).device
        total = torch.stack(sq).sum() if sq else torch.zeros((), device=device)
        if self.norm_group is not None:
            dist.all_reduce(total, group=self.norm_group)
        return torch.sqrt(total)

    def moments(self, p):
        """``(mu, nu)`` of parameter ``p``: optax's first and second moments,
        in ``p``'s dtype, zeros before the first update. Checkpoints save and
        restore them in place (``train_state.state_leaves``), with
        ``count``."""
        state = self.state[p]
        if not state:
            ref = self._owned(p, p)
            state["mu"] = torch.zeros(ref.shape, dtype=p.dtype, device=p.device)
            state["nu"] = torch.zeros(ref.shape, dtype=p.dtype, device=p.device)
        return state["mu"], state["nu"]

    def _owned(self, p, t):
        """The slice of ``t`` (``p`` or its gradient) this rank updates:
        all of it unless ZeRO-1 gave ``p`` a region."""
        from pyrecover_tpu_torch.parallel.sharding import owned

        region = self.regions.get(p, ())
        return t if region == () else owned(t, region)

    @torch.no_grad()
    def step(self, closure=None):
        grads = {p: p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None}
        self.last_grad_norm = None
        if self.max_norm > 0 or self.norm_owners is not None:
            self.last_grad_norm = self.grad_norm(grads)
        if self.max_norm > 0:
            norm = self.last_grad_norm.to(_norm_dtype(grads.values()))
            clip = norm >= _rounded(self.max_norm, norm.dtype)
            # each leaf scales in its own dtype, by the norm cast to it
            grads = {p: torch.where(clip, g / norm.to(g.dtype) * _rounded(self.max_norm, g.dtype),
                                    g)
                     for p, g in grads.items()}
        t = self.count + 1
        for group in self.param_groups:
            b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
            lr = group["lr"](self.count)
            c1, c2 = 1.0 - b1**t, 1.0 - b2**t
            for param in group["params"]:
                if param not in grads or self.regions.get(param, ()) is None:
                    continue  # ZeRO-1: another rank's part
                mu, nu = self.moments(param)
                p, g = self._owned(param, param), self._owned(param, grads[param])
                if p.dtype != torch.float32:
                    _adam_low_precision(p, g, mu, nu, lr, b1, b2, eps, wd, t)
                    continue
                g = g.float()
                mu.mul_(b1).add_((1 - b1) * g)
                nu.mul_(b2).add_((1 - b2) * g * g)
                update = (mu / c1) / (torch.sqrt(nu / c2) + eps) + wd * p
                p.add_(update.to(p.dtype), alpha=-lr)
        if self.zero1_leaves:
            from pyrecover_tpu_torch.parallel.sharding import allgather_leaf

            del grads  # the clipped copies: the gathers' buffers take their room
            for shard, parts in self.zero1_leaves:
                allgather_leaf(shard, parts)
        self.count = t


def build_optimizer(config, params, model=None):
    """``(optimizer, schedule)`` for a TrainConfig: AdamW over ``params``
    with the warmup schedule and, when enabled, global-norm clipping. Under
    ``--optimizer-sharding zero1`` in a group of several ranks the moments
    are sharded over ``model``'s leaves (`OptaxAdamW.shard_moments`); in one
    process zero1 is the replicated update, as in JAX with a data axis of 1."""
    if config.lr_schedule == "cosine":
        schedule = warmup_cosine_schedule(
            config.learning_rate, config.lr_warmup_steps,
            config.training_steps, config.lr_min_ratio,
        )
    else:
        schedule = warmup_constant_schedule(config.learning_rate, config.lr_warmup_steps)
    max_norm = config.grad_max_norm if config.grad_clipping else 0.0
    from pyrecover_tpu_torch.parallel.sharding import local_tensor

    # FSDP2's parameters are DTensors: AdamW runs on their local shards
    opt = OptaxAdamW(
        [local_tensor(p) for p in params], lr=schedule, b1=config.adam_b1,
        b2=config.adam_b2, eps=1e-8,
        weight_decay=config.weight_decay, max_norm=max_norm,
    )
    if config.optimizer_sharding == "zero1":
        from pyrecover_tpu_torch.parallel import mesh

        if model is None:
            raise ValueError("--optimizer-sharding zero1 needs the model to lay its "
                             "moments out over the data axis")
        if mesh.world_size() > 1:
            live = getattr(model, "mesh", None)
            opt.shard_moments(model, live or mesh.DeviceMesh({mesh.AXIS_DATA: mesh.world_size()},
                                                             mesh.rank()))
    return opt, schedule
