"""Process groups over ``torch.distributed`` (the JAX package's
``parallel/mesh.py``): the pipeline, data, fsdp, tensor, sequence and expert
axes.

The reference starts one process per GPU and meets at a rendezvous built
from the SLURM environment (``dist_utils.py:38-68``); the JAX package asks
the TPU runtime. Here a process reads ``torchrun``'s variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or, where
they are missing, SLURM's (``SLURM_PROCID``, ``SLURM_NTASKS``,
``SLURM_LOCALID``, with ``MASTER_ADDR``/``MASTER_PORT`` from the launcher),
and calls ``init_process_group`` with an explicit ``tcp://`` address, rank,
world size and backend. The backend is the caller's choice, never a
fallback: ``cuda:nccl,cpu:gloo`` on the card (NCCL for the gradients, gloo
for the host-side object broadcasts and the sharded engine's asynchronous
save), ``gloo`` on the CPU. Each process takes the card ``cuda:LOCAL_RANK``;
a local rank past the card count raises, rather than wrapping two ranks
onto one card.

Failure policy (``initialize_distributed``), as the JAX package's: with
``required`` and no cluster environment it raises; with a cluster
environment whose rendezvous fails it raises; with neither it does nothing
(one process).

The mesh (`MeshConfig`, `DeviceMesh`): pipeline x data x fsdp x tensor x
sequence x expert processes, one a card, in JAX's axis order
(``MESH_AXES``: pipeline outermost, expert innermost), so rank
``((((p * data + d) * fsdp + f) * tensor + t) * sequence + s) * expert + e``
sits at ``(p, d, f, t, s, e)``; at sequence and pipeline 1 that is the
data x fsdp x tensor x expert order of the earlier meshes, so their layouts
and checkpoints keep their coordinates. `build_mesh` makes, over the
existing group (every rank makes every group, in one order), one subgroup
for every set of the mesh's axes above 1: the ranks that differ only on
those axes (`DeviceMesh.axes_group`). The named ones (``GROUP_AXES``):
``data``, ``fsdp``, ``tensor``, ``sequence``, ``pipeline`` and ``expert``
(one axis), ``batch`` (data x fsdp: the ranks that hold other rows of the
global batch; JAX's batch spec ``P((data, fsdp), sequence)`` leaves rows
whole over tensor, expert and pipeline and splits their columns over
sequence), ``expert_tensor`` (expert x tensor: the ranks whose partial MoE
outputs one all-reduce sums, ``models/moe.py``) and ``model`` (every axis
but data: the ranks that hold one replica's slices, stages and sequence
chunks). A group of one rank is None (its collectives are skipped); a group
of the whole world is the default group.

Point to point (`ring_shift`, `p2p_exchange`): the sequence ring and the
pipeline's stage-to-stage sends. NCCL moves CUDA tensors directly; gloo,
the backend two ranks on one card share, stages them through host buffers
(an explicit branch on the group's backend, `p2p_route`; ``python
tests/test_torch_pipeline.py p2p-probe`` records what gloo does with CUDA
tensors on the card). An exchange posts each peer's sends and receives at
once (``batch_isend_irecv``), peer by peer in the global order of rank
pairs, so no rank waits on an order another keeps.

The host-0 helpers (``sync_global_devices``, ``broadcast_host0_scalar``,
``broadcast_host0_obj``) are identities in one process and otherwise run
inside ``telemetry.collective_phase``, so a rank that never arrives becomes
a named ``distributed_wait_timeout`` with a flight bundle, not silence.
They travel over the process group's CPU backend.
"""

import dataclasses
import datetime
import json
import os

import torch
import torch.distributed as dist

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.telemetry import bus

AXIS_PIPE = "pipeline"
AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "sequence"
AXIS_EXPERT = "expert"
# the axes, outermost first (a rank's coordinates in this order)
MESH_AXES = (AXIS_PIPE, AXIS_DATA, AXIS_FSDP, AXIS_TENSOR, AXIS_SEQ, AXIS_EXPERT)
# bound on the rendezvous and on every collective of the group
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The logical mesh: ``pipeline`` x ``data`` x ``fsdp`` x ``tensor`` x
    ``sequence`` x ``expert`` processes; ``data=-1`` means every process the
    other axes leave."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1
    pipeline: int = 1
    expert: int = 1

    def __post_init__(self):
        if self.data == 0 or self.data < -1:
            raise ValueError(f"--dp must be positive or -1, got {self.data}")
        for flag, n in (("--fsdp", self.fsdp), ("--tp", self.tensor), ("--sp", self.sequence),
                        ("--pp", self.pipeline), ("--ep", self.expert)):
            if n < 1:
                raise ValueError(f"{flag} must be >= 1, got {n}")

    def shape(self, n_processes):
        """The axes' sizes over ``n_processes`` (one card each), as JAX's
        ``MeshConfig.resolve``: the data axis takes what the others leave,
        and the product must be the process count. The sequence and
        pipeline axes are listed where they are above 1."""
        fixed = self.pipeline * self.fsdp * self.tensor * self.sequence * self.expert
        data = self.data
        if data == -1:
            if n_processes % fixed:
                raise ValueError(
                    f"{n_processes} processes not divisible by "
                    f"pipeline*fsdp*tensor*sequence*expert={fixed} (--pp {self.pipeline} x "
                    f"--fsdp {self.fsdp} x --tp {self.tensor} x --sp {self.sequence} x "
                    f"--ep {self.expert})")
            data = n_processes // fixed
        if data * fixed != n_processes:
            axes = ("" if fixed == 1 else
                    f" x --pp {self.pipeline} x --fsdp {self.fsdp} x --tp {self.tensor} x "
                    f"--sp {self.sequence} x --ep {self.expert}")
            raise ValueError(
                f"--dp {data}{axes} != {n_processes} processes: Mesh pp{self.pipeline}xdp{data}"
                f"xfsdp{self.fsdp}xtp{self.tensor}xsp{self.sequence}xep{self.expert}="
                f"{data * fixed} != available devices {n_processes} (the port runs one mesh "
                "position per process)")
        shape = {AXIS_DATA: data, AXIS_FSDP: self.fsdp, AXIS_TENSOR: self.tensor,
                 AXIS_EXPERT: self.expert}
        # the sequence and pipeline axes where they split (a missing axis is 1)
        shape.update({a: n for a, n in ((AXIS_SEQ, self.sequence), (AXIS_PIPE, self.pipeline))
                      if n > 1})
        return shape

    def resolve(self, n_processes):
        """The data axis size over ``n_processes`` (one card each)."""
        return self.shape(n_processes)[AXIS_DATA]


def coords_of(rank, shape):
    """The coordinates of ``rank`` on a mesh of ``shape`` (pipeline
    outermost, expert innermost; an axis ``shape`` lacks is 1): data, fsdp,
    tensor and expert always, the sequence and pipeline axes where
    ``shape`` names them."""
    out, rank = {}, int(rank)
    for axis in reversed(MESH_AXES[1:]):
        n = int(shape.get(axis, 1))
        out[axis] = rank % n
        rank //= n
    out[MESH_AXES[0]] = rank
    return {a: out[a] for a in MESH_AXES if a in shape or a not in (AXIS_SEQ, AXIS_PIPE)}


def mesh_size(shape):
    """The ranks of a mesh of ``shape``."""
    n = 1
    for a in MESH_AXES:
        n *= int(shape.get(a, 1))
    return n


# a named group -> the axes its ranks differ on
GROUP_AXES = {AXIS_DATA: (AXIS_DATA,), AXIS_FSDP: (AXIS_FSDP,), AXIS_TENSOR: (AXIS_TENSOR,),
              AXIS_SEQ: (AXIS_SEQ,), AXIS_PIPE: (AXIS_PIPE,), AXIS_EXPERT: (AXIS_EXPERT,),
              "batch": (AXIS_DATA, AXIS_FSDP), "expert_tensor": (AXIS_TENSOR, AXIS_EXPERT),
              "model": (AXIS_PIPE, AXIS_FSDP, AXIS_TENSOR, AXIS_SEQ, AXIS_EXPERT)}


def axes_ranks(axes, rank, shape):
    """The ranks that differ from ``rank`` only on ``axes``, ascending."""
    mine = coords_of(rank, shape)
    return [r for r in range(mesh_size(shape))
            if all(coords_of(r, shape).get(a, 0) == mine.get(a, 0)
                   for a in MESH_AXES if a not in axes)]


def group_ranks(name, rank, shape):
    """The ranks of ``rank``'s group ``name`` (`GROUP_AXES`), ascending."""
    return axes_ranks(GROUP_AXES[name], rank, shape)


class DeviceMesh:
    """This process's place on the live mesh and its named groups (see the
    module docstring). ``group(name)`` is None for a group of one rank (no
    collective), the default group for the whole world."""

    def __init__(self, shape, rank, groups=None):
        self.shape = {a: int(shape.get(a, 1)) for a in MESH_AXES}
        self.rank = int(rank)
        self.coords = coords_of(rank, self.shape)
        # frozenset of the axes above 1 -> this rank's group over them
        self._groups = dict(groups or {})

    @property
    def batch_shards(self):
        """The ways the global batch is split: data x fsdp (JAX's batch spec
        ``P((data, fsdp), sequence)``)."""
        return self.shape[AXIS_DATA] * self.shape[AXIS_FSDP]

    @property
    def batch_index(self):
        """This rank's slot among the batch shards (data major)."""
        return self.coords[AXIS_DATA] * self.shape[AXIS_FSDP] + self.coords[AXIS_FSDP]

    @property
    def model_sharded(self):
        """Any axis but data above 1: the step is the mesh step."""
        return any(self.shape[a] > 1 for a in MESH_AXES if a != AXIS_DATA)

    def axes_group(self, axes):
        """This rank's group over ``axes`` (the ranks that differ only
        there), None when those axes hold it alone."""
        return self._groups.get(frozenset(a for a in axes if self.shape[a] > 1))

    def group(self, name):
        return self.axes_group(GROUP_AXES[name])

    def axes_ranks(self, axes):
        return axes_ranks(axes, self.rank, self.shape)

    def neighbour(self, axis, step):
        """The global rank ``step`` places along ``axis`` (cyclic)."""
        coords = dict(self.coords)
        coords[axis] = (coords[axis] + step) % self.shape[axis]
        rank = 0
        for a in MESH_AXES:
            rank = rank * self.shape[a] + coords[a]
        return rank

    def __repr__(self):
        axes = ", ".join(f"{a}={self.shape[a]}" for a in MESH_AXES)
        return f"DeviceMesh({axes}, rank={self.rank} at {self.coords})"


def build_mesh(shape):
    """The live `DeviceMesh` of ``shape`` over the process group (or of one
    process without one): every rank makes the subgroup of every set of the
    axes above 1, in one order, and keeps its own."""
    import itertools

    rank_ = rank()
    world = world_size()
    n = mesh_size(shape)
    if n != world:
        raise ValueError(f"mesh {shape} holds {n} ranks, the process group {world}")
    live = [a for a in MESH_AXES if int(shape.get(a, 1)) > 1]
    groups = {}
    for k in range(1, len(live) + 1):
        for axes in itertools.combinations(live, k):
            members = sorted({tuple(axes_ranks(axes, r, shape)) for r in range(world)})
            if len(members[0]) == world:
                groups[frozenset(axes)] = dist.group.WORLD
                continue
            for ranks in members:
                g = dist.new_group(list(ranks))
                if rank_ in ranks:
                    groups[frozenset(axes)] = g
    return DeviceMesh(shape, rank_, groups)


def topology(shape):
    """The checkpoint meta's ``topology`` for a mesh of ``shape`` (a dict of
    axis sizes, or an int: that many data replicas), as the JAX package
    records a mesh (``topology_of``)."""
    if not isinstance(shape, dict):
        shape = {AXIS_DATA: int(shape)}
    n = mesh_size(shape)
    if n <= 1:
        return {"devices": 1, "processes": 1, "mesh": None}
    mesh = {a: int(shape.get(a, 1)) for a in MESH_AXES}
    return {"devices": n, "processes": n, "mesh": mesh}


def cluster_env(environ=None):
    """``{rank, world_size, local_rank, master_addr, master_port, source}``
    from ``torchrun``'s variables, else SLURM's, or None when neither
    names a world size. Addresses may be None (the rendezvous then fails)."""
    env = os.environ if environ is None else environ
    if env.get("WORLD_SIZE"):
        rank, world, local, source = (env.get("RANK", "0"), env["WORLD_SIZE"],
                                      env.get("LOCAL_RANK", "0"), "torchrun")
    elif env.get("SLURM_NTASKS"):
        rank, world, local, source = (env.get("SLURM_PROCID", "0"), env["SLURM_NTASKS"],
                                      env.get("SLURM_LOCALID", "0"), "slurm")
    else:
        return None
    return {"rank": int(rank), "world_size": int(world), "local_rank": int(local),
            "master_addr": env.get("MASTER_ADDR"), "master_port": env.get("MASTER_PORT"),
            "source": source}


def default_backend(device_type):
    """NCCL for CUDA tensors with gloo beside it for host objects on the
    card; gloo on the CPU."""
    return "cuda:nccl,cpu:gloo" if device_type == "cuda" else "gloo"


def is_distributed():
    return dist.is_available() and dist.is_initialized()


def world_size():
    return dist.get_world_size() if is_distributed() else 1


def rank():
    return dist.get_rank() if is_distributed() else 0


def local_device(device_type="cuda", environ=None):
    """``cuda:LOCAL_RANK`` (raising when the host has fewer cards), or the
    CPU. Never a local rank modulo the card count: two ranks on one card
    would be a silent wrong topology."""
    if device_type != "cuda":
        return torch.device("cpu")
    env = cluster_env(environ)
    local = env["local_rank"] if env is not None else 0
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pyrecover_tpu_torch runs on the card; pass --device cpu to run "
            "on the CPU")
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK {local} but this host has {torch.cuda.device_count()} CUDA "
            "device(s): one process per card")
    return torch.device("cuda", local)


def initialize_distributed(required=False, backend=None, device_type="cuda",
                           timeout_s=DEFAULT_TIMEOUT_S, environ=None):
    """Join the process group the environment names (reference
    ``dist_utils.py:38-68``). Returns the environment dict, or None when
    the run is one process.

    No cluster environment (or one naming a world of 1 without
    ``required``): a no-op, unless ``required``, which raises. A cluster
    environment whose rendezvous fails raises. ``backend`` defaults to
    `default_backend` of ``device_type``; it is never switched after a
    failure."""
    if is_distributed():
        return cluster_env(environ)
    env = cluster_env(environ)
    if env is None or (env["world_size"] <= 1 and not required):
        if required:
            raise RuntimeError(
                "--distributed requested but no cluster environment found: set RANK, "
                "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT (torchrun), or run "
                "under srun with MASTER_ADDR/MASTER_PORT (launch/launch_multinode.sh). "
                "Refusing to fall back to single-process (reference dist_utils.py:64-65)."
            )
        return None
    backend = backend or default_backend(device_type)
    try:
        if not env["master_addr"] or not env["master_port"]:
            raise ValueError("MASTER_ADDR and MASTER_PORT must both be set")
        if device_type == "cuda":
            torch.cuda.set_device(local_device("cuda", environ))
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{env['master_addr']}:{env['master_port']}",
            rank=env["rank"], world_size=env["world_size"],
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    except Exception as e:
        raise RuntimeError(
            f"distributed rendezvous failed ({type(e).__name__}: {e}); refusing to continue "
            "single-process with a cluster environment present"
        ) from e
    # events emitted before the rendezvous were stamped host 0
    bus.reset_process_index()
    return env


def destroy_distributed():
    """Leave the process group (a no-op without one); the host stamp
    re-resolves to 0."""
    if is_distributed():
        dist.destroy_process_group()
        bus.reset_process_index()


def sync_global_devices(tag="barrier"):
    """Cross-process barrier (reference ``dist.barrier()``): a one-element
    all-reduce over the group's CPU backend, bounded by a
    ``collective_phase``. A no-op in one process."""
    if world_size() > 1:
        with telemetry.collective_phase(f"barrier:{tag}"):
            dist.all_reduce(torch.zeros(1))


def broadcast_host0_scalar(value):
    """Host 0 decides, every rank follows (reference ``train.py:342-346``):
    host 0's ``value`` on every rank. An identity in one process."""
    if world_size() <= 1:
        return value
    with telemetry.collective_phase("broadcast_host0_scalar"):
        out = [value]
        dist.broadcast_object_list(out, src=0, device=torch.device("cpu"))
    return out[0]


def broadcast_host0_obj(obj):
    """Host 0 decides a structured value (a candidate list, a verdict);
    every rank follows. JSON round trip, so the payload must be JSON-ready;
    the ranks' payloads may differ in size (the length travels first). An
    identity in one process."""
    if world_size() <= 1:
        return obj
    payload = torch.frombuffer(bytearray(json.dumps(obj).encode("utf-8")), dtype=torch.uint8)
    with telemetry.collective_phase("broadcast_host0_obj"):
        n = torch.tensor([payload.numel()], dtype=torch.int64)
        dist.broadcast(n, src=0)
        buf = payload if payload.numel() == int(n) else torch.zeros(int(n), dtype=torch.uint8)
        dist.broadcast(buf, src=0)
    return json.loads(bytes(buf.numpy()).decode("utf-8"))


# ---- point to point: the sequence ring and the pipeline's stage sends -----------

_P2P_READY = set()


def p2p_route(device, group=None):
    """How a point-to-point send of a tensor on ``device`` travels over
    ``group``'s backend: ``"direct"`` (a CPU tensor, or a CUDA tensor over
    NCCL) or ``"gloo-host"`` (a CUDA tensor over gloo: staged through a host
    buffer each way)."""
    if torch.device(device).type != "cuda":
        return "direct"
    return "direct" if "nccl" in str(dist.get_backend(group)) else "gloo-host"


def p2p_ready(device, group=None):
    """Make ``group`` ready for point-to-point sends of tensors on
    ``device``: NCCL's first call on a group must be one every member makes
    (a pipeline tick sends between two stages only), so every member calls
    this first; once a group, a no-op elsewhere."""
    if (torch.device(device).type != "cuda" or p2p_route(device, group) != "direct"
            or group in _P2P_READY):
        return
    dist.all_reduce(torch.zeros(1, device=device), group=group)
    _P2P_READY.add(group)


def p2p_exchange(sends, recvs, group=None):
    """Send and receive, and wait for it: ``sends`` ``[(tensor, global
    rank)]``, ``recvs`` ``[(template tensor, global rank)]`` (a received
    tensor takes its template's shape, dtype and device). Returns the
    received tensors, in ``recvs``' order. Pairs of ranks that send each
    other several tensors must list them in one order on both sides. All
    of a rank's sends and receives are posted at once
    (``batch_isend_irecv``: over NCCL one group call, so a ring's shift is
    one hop on every link at once), after `p2p_ready`'s warm-up of the
    group. Over gloo a CUDA tensor is staged through the host
    (`p2p_route`)."""
    probe = sends[0][0] if sends else recvs[0][0] if recvs else None
    if probe is None:
        return []
    staged = p2p_route(probe.device, group) == "gloo-host"
    if probe.device.type == "cuda" and not staged and group not in _P2P_READY:
        raise RuntimeError("p2p_ready must run on every member of the group before its first "
                           "point-to-point exchange over NCCL")
    ops, bufs = [], []
    for tensor, peer in sends:
        tensor = tensor.detach()
        ops.append(dist.P2POp(dist.isend, tensor.cpu() if staged else tensor.contiguous(),
                              int(peer), group=group))
    for template, peer in recvs:
        buf = torch.empty(template.shape, dtype=template.dtype,
                          device="cpu" if staged else template.device)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, int(peer), group=group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [buf.to(probe.device) if staged else buf for buf in bufs]


def ring_shift(tensors, mesh, axis=AXIS_SEQ):
    """Every rank of ``axis``'s ring sends ``tensors`` to the next one and
    gets the previous one's (JAX's ``ppermute`` with ``i -> i + 1``)."""
    nxt, prev = mesh.neighbour(axis, 1), mesh.neighbour(axis, -1)
    group = mesh.group(axis)
    p2p_ready(tensors[0].device, group)  # every member of the ring calls this
    return p2p_exchange([(t, nxt) for t in tensors], [(t, prev) for t in tensors], group)
