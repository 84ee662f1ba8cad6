"""Process groups over ``torch.distributed`` (the JAX package's
``parallel/mesh.py``): the data, fsdp, tensor and expert axes.

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

The mesh (`MeshConfig`, `DeviceMesh`): data x fsdp x tensor x expert
processes, one a card, in JAX's axis order (``MESH_AXES``: data outermost,
expert innermost), so rank ``((d * fsdp + f) * tensor + t) * expert + e``
sits at ``(d, f, t, e)``. `build_mesh` makes the named subgroups over the
existing group (every rank makes every group, in one order): ``data``,
``fsdp``, ``tensor`` and ``expert`` (the ranks that differ only on that
axis), ``batch`` (data x fsdp: the ranks that hold other rows of the global
batch, at one tensor and expert index; JAX's batch spec ``P((data, fsdp),
sequence)`` leaves rows whole over tensor and expert), ``expert_tensor``
(expert x tensor: the ranks whose partial MoE outputs one all-reduce sums,
``models/moe.py``) and ``model`` (fsdp x tensor x expert: the ranks that
hold one replica's slices, at one data index). A group of one rank is None
(its collectives are skipped); a group of the whole world is the default
group. The sequence and pipeline axes are not ported: above 1 they raise
``NotImplementedError`` naming ROADMAP Queue 1, item 8.

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

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_EXPERT = "expert"
MESH_AXES = ("pipeline", "data", "fsdp", "tensor", "sequence", "expert")
# the ported axes, outermost first (a rank's coordinates in this order)
PORTED_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_TENSOR, AXIS_EXPERT)
# the axes that are not ported, and the ROADMAP item that holds them
_UNPORTED_AXES = ("sequence", "pipeline")
_UNPORTED_ITEM = "ROADMAP Queue 1, item 8"
# bound on the rendezvous and on every collective of the group
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The logical mesh: ``data`` x ``fsdp`` x ``tensor`` x ``expert``
    processes; ``data=-1`` means every process the other axes leave."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1
    pipeline: int = 1
    expert: int = 1

    def __post_init__(self):
        for axis in _UNPORTED_AXES:
            if getattr(self, axis) > 1:
                raise NotImplementedError(
                    f"{axis} {getattr(self, axis)} > 1 is not ported ({_UNPORTED_ITEM})")
        if self.data == 0 or self.data < -1:
            raise ValueError(f"--dp must be positive or -1, got {self.data}")
        for flag, n in (("--fsdp", self.fsdp), ("--tp", self.tensor), ("--ep", self.expert)):
            if n < 1:
                raise ValueError(f"{flag} must be >= 1, got {n}")

    def shape(self, n_processes):
        """``{data, fsdp, tensor, expert}`` over ``n_processes`` (one card
        each), as JAX's ``MeshConfig.resolve``: the data axis takes what the
        others leave, and the product must be the process count."""
        fixed = self.fsdp * self.tensor * self.expert
        data = self.data
        if data == -1:
            if n_processes % fixed:
                raise ValueError(
                    f"{n_processes} processes not divisible by "
                    f"pipeline*fsdp*tensor*sequence*expert={fixed} (--fsdp {self.fsdp} x "
                    f"--tp {self.tensor} x --ep {self.expert})")
            data = n_processes // fixed
        if data * fixed != n_processes:
            axes = ("" if fixed == 1 else
                    f" x --fsdp {self.fsdp} x --tp {self.tensor} x --ep {self.expert}")
            raise ValueError(
                f"--dp {data}{axes} != {n_processes} processes: Mesh pp1xdp{data}"
                f"xfsdp{self.fsdp}xtp{self.tensor}xsp1xep{self.expert}={data * fixed} != "
                f"available devices {n_processes} (the port runs one mesh position per "
                "process)")
        return {AXIS_DATA: data, AXIS_FSDP: self.fsdp, AXIS_TENSOR: self.tensor,
                AXIS_EXPERT: self.expert}

    def resolve(self, n_processes):
        """The data axis size over ``n_processes`` (one card each)."""
        return self.shape(n_processes)[AXIS_DATA]


def coords_of(rank, shape):
    """``{data, fsdp, tensor, expert}`` of ``rank`` on a mesh of ``shape``
    (expert innermost)."""
    out, rank = {}, int(rank)
    for axis in reversed(PORTED_AXES[1:]):
        n = int(shape.get(axis, 1))
        out[axis] = rank % n
        rank //= n
    out[AXIS_DATA] = rank
    return {a: out[a] for a in PORTED_AXES}


def mesh_size(shape):
    """The ranks of a mesh of ``shape``."""
    n = 1
    for a in PORTED_AXES:
        n *= int(shape.get(a, 1))
    return n


# a named group -> the axes its ranks differ on
GROUP_AXES = {AXIS_DATA: (AXIS_DATA,), AXIS_FSDP: (AXIS_FSDP,), AXIS_TENSOR: (AXIS_TENSOR,),
              AXIS_EXPERT: (AXIS_EXPERT,), "batch": (AXIS_DATA, AXIS_FSDP),
              "expert_tensor": (AXIS_TENSOR, AXIS_EXPERT),
              "model": (AXIS_FSDP, AXIS_TENSOR, AXIS_EXPERT)}


def group_ranks(name, rank, shape):
    """The ranks of ``rank``'s group ``name`` (`GROUP_AXES`), ascending."""
    axes = GROUP_AXES[name]
    mine = coords_of(rank, shape)
    return [r for r in range(mesh_size(shape))
            if all(coords_of(r, shape)[a] == mine[a] for a in PORTED_AXES if a not in axes)]


class DeviceMesh:
    """This process's place on the live mesh and its named groups (see the
    module docstring). ``group(name)`` is None for a group of one rank (no
    collective), the default group for the whole world."""

    def __init__(self, shape, rank, groups=None):
        self.shape = {a: int(shape.get(a, 1)) for a in PORTED_AXES}
        self.rank = int(rank)
        self.coords = coords_of(rank, self.shape)
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
        return any(self.shape[a] > 1 for a in PORTED_AXES[1:])

    def group(self, name):
        return self._groups.get(name)

    def __repr__(self):
        axes = ", ".join(f"{a}={self.shape[a]}" for a in PORTED_AXES)
        return f"DeviceMesh({axes}, rank={self.rank} at {self.coords})"


def build_mesh(shape):
    """The live `DeviceMesh` of ``shape`` over the process group (or of one
    process without one): every rank makes every named subgroup, in one
    order, and keeps its own."""
    rank_ = rank()
    world = world_size()
    n = mesh_size(shape)
    if n != world:
        raise ValueError(f"mesh {shape} holds {n} ranks, the process group {world}")
    groups = {}
    for name in GROUP_AXES:
        members = sorted({tuple(group_ranks(name, r, shape)) for r in range(world)})
        if len(members[0]) == 1:
            continue  # no collective
        if len(members[0]) == world:
            groups[name] = dist.group.WORLD
            continue
        for ranks in members:
            g = dist.new_group(list(ranks))
            if rank_ in ranks:
                groups[name] = g
    return DeviceMesh(shape, rank_, groups)


def topology(shape):
    """The checkpoint meta's ``topology`` for a mesh of ``shape`` (a
    ``{data, fsdp, tensor, expert}`` dict, or an int: that many data
    replicas), as the JAX package records a mesh (``topology_of``)."""
    if not isinstance(shape, dict):
        shape = {AXIS_DATA: int(shape)}
    n = mesh_size(shape)
    if n <= 1:
        return {"devices": 1, "processes": 1, "mesh": None}
    mesh = {axis: 1 for axis in MESH_AXES}
    mesh.update({a: int(shape.get(a, 1)) for a in PORTED_AXES})
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
