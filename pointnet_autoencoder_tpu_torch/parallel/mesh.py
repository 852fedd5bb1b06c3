"""Data parallelism over ``torch.distributed``, and the (data, model)
grid of ranks that tensor parallelism and DP x SP add to it: the devices
of the ranks, the process groups of a rank and their collectives, and the
launcher.

Counterpart of ``pointnet_autoencoder_tpu/parallel/mesh.py``. The JAX
package runs one program over a mesh and lets GSPMD insert the gradient
all-reduce and the global-batch BatchNorm reductions. Here each rank is a
process that runs the whole step on its rows of the global batch, and the
port inserts the collectives by hand:

- every training BatchNorm (``nn/layers.py``) and the fused head's
  statistics (``ops/fused_head.py:head_stats``) average their moments over
  the group with ``DataGroup.all_reduce_mean``, a differentiable all-reduce,
  so the statistics and their gradients are the global batch's;
- after ``backward`` one flat all-reduce averages every gradient
  (``DataGroup.average_gradients``; under point parallelism, where each
  rank's loss is its share of the global loss, it sums them:
  ``sum_gradients``), before the optimizer steps;
- metrics and the preemption flag ride one all-reduce where the host
  waits anyway (``train/loop.py``).

Every all-reduce of a step goes through ``utils/graphs.collective``: on
a card, a rank of a gloo group records its step as a tape of graphs
with the collectives run eagerly between them, and a rank of an NCCL
group captures them inside its one graph (``train/loop.py``).

With ``model_parallel`` m > 1 the k ranks form a (k/m, m) grid in JAX's
row-major order, rank = d*m + t (``ProcessMesh``): the ranks of one model
group (same d) hold one data shard and split the decoder's FC layers
(``parallel/tp.py``), or, under DP x SP, the points (``parallel/sp.py``);
the ranks of one data group (same t) hold the same slices and average
over the batch. At m = 1 the data group is the whole world.

Serving is one process with a model replica per device of ``make_mesh``
(``inference.py``); it needs no process group.

The collectives are ``all_reduce`` and ``broadcast`` only: gloo runs both
on CUDA tensors, which lets two ranks share one card (NCCL refuses two
ranks on one device).
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Callable, List, Mapping, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from pointnet_autoencoder_tpu_torch.device import resolve_device
from pointnet_autoencoder_tpu_torch.utils import graphs

Tensor = torch.Tensor

# What a launcher such as torchrun exports to every rank.
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")
# What SLURM's srun exports to every task, and Open MPI's mpirun (before
# version 5) to every process; the JAX package's hook hands both to jax's
# own detectors (jax/_src/clusters), whose rules these follow.
SLURM_ENV = ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
             "SLURM_PROCID", "SLURM_LOCALID")
OMPI_ENV = ("OMPI_MCA_orte_hnp_uri", "OMPI_COMM_WORLD_SIZE",
            "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")
# Open MPI 5 (PRRTE) marks its processes with this; jax 0.9.0 has no
# detector for it, and neither has this hook.
PRTE_MARKER = "PRTE_LAUNCHED"
# Both schedulers' coordinator ports lie in [65535 - 4096 + 1, 65535].
_PORT_BASE = 65535 - 4096 + 1

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(devices: Optional[Sequence] = None,
              data_parallel: Optional[int] = None,
              model_parallel: int = 1) -> List[torch.device]:
    """The devices of the (data, model) grid, one per rank or replica
    shard, in rank order: rank d*m + t is data index d, model index t.

    With ``devices`` None they are distinct cards ``cuda:0..k-1``, k =
    ``data_parallel`` * ``model_parallel``; ``data_parallel`` None takes
    every visible card (as many model groups as fit). An explicit
    ``devices`` list is taken in order (its first k entries; with
    ``data_parallel`` None as many model groups as it holds) and may name
    one device more than once: that puts several ranks or replicas on one
    card or on the CPU. Raises ValueError when more devices are asked for
    than exist, and RuntimeError for a CUDA device without a card; nothing
    moves to fewer devices or to the CPU."""
    if data_parallel is not None and data_parallel < 1:
        raise ValueError(f"data_parallel={data_parallel} must be >= 1")
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel} must be >= 1")
    m = model_parallel
    grid = "" if m == 1 else f" x model_parallel={m}"
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        d = count // m if data_parallel is None else data_parallel
        if d == 0 or d * m > count:
            asked = ("None (every visible card)" if data_parallel is None
                     else data_parallel)
            raise ValueError(
                f"data_parallel={asked}{grid} needs {max(d * m, m)} CUDA "
                f"device(s) but {count} are available; pass devices=[...] "
                f"to name the devices (the CPU included) explicitly")
        return [torch.device("cuda", i) for i in range(d * m)]
    devices = list(devices)
    d = len(devices) // m if data_parallel is None else data_parallel
    if d == 0 or d * m > len(devices):
        raise ValueError(
            f"data_parallel={d}{grid} needs {max(d * m, m)} devices but only "
            f"{len(devices)} are given ({[str(x) for x in devices]})")
    return [resolve_device(x) for x in devices[:d * m]]


def check_batch_divisible(batch_size: int, data_parallel: int) -> None:
    if batch_size % data_parallel != 0:
        raise ValueError(
            f"batch_size={batch_size} must be divisible by the "
            f"data-parallel degree {data_parallel}")


def slurm_coordinator(env: Mapping[str, str] = os.environ) -> str:
    """``host:port`` of rank 0's store under SLURM, by jax's rule
    (``SlurmCluster.get_coordinator_address``): the first host of
    SLURM_STEP_NODELIST, whose forms are 'node001', 'node001,host2',
    'node[001-015],host2' and 'node[001,007-015],host2', and the port
    SLURM_JOB_ID % 4096 + 61440."""
    port = int(env["SLURM_JOB_ID"]) % 4096 + _PORT_BASE
    nodes = env["SLURM_STEP_NODELIST"]
    cut = next((i for i, ch in enumerate(nodes) if ch in ",["), len(nodes))
    if cut == len(nodes) or nodes[cut] == ",":
        return f"{nodes[:cut]}:{port}"
    rest = nodes[cut + 1:]
    end = next((i for i, ch in enumerate(rest) if ch in ",-"), None)
    return f"{nodes[:cut]}{rest[:end]}:{port}"


def ompi_coordinator(env: Mapping[str, str] = os.environ) -> str:
    """``host:port`` of rank 0's store under Open MPI's mpirun, by jax's
    rule (``OmpiCluster.get_coordinator_address``): the launcher's first
    address in OMPI_MCA_orte_hnp_uri (tcp, or tcp6 unbracketed), and a
    port from its job id, ``jobid // 4096 % 4096 + 61440``."""
    uri = env["OMPI_MCA_orte_hnp_uri"]
    port = int(uri.split(".", 1)[0]) // 4096 % 4096 + _PORT_BASE
    match = re.search(r"tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]", uri)
    if match is None:
        raise RuntimeError(f"no launcher address in OMPI_MCA_orte_hnp_uri="
                           f"{uri!r}")
    return f"{next(g for g in match.groups() if g is not None)}:{port}"


class Rendezvous(NamedTuple):
    """Where and as what this process joins its group: the launcher's
    name, ``init_process_group``'s ``init_method``, the world size, this
    process's rank and its local rank (its card on the host)."""
    launcher: str
    init_method: str
    world_size: int
    rank: int
    local_rank: int


def _need(env: Mapping[str, str], names: Sequence[str], who: str) -> None:
    missing = [v for v in names if v not in env]
    if missing:
        present = [v for v in names if v in env]
        raise RuntimeError(
            f"{who}: {', '.join(present)} set but {', '.join(missing)} "
            f"missing. Export all of {', '.join(LAUNCHER_ENV)} on every "
            f"rank (torchrun does so) to name the group directly")


def _tcp(address: str) -> str:
    """``tcp://`` init method of a ``host:port`` (an IPv6 host
    bracketed)."""
    host, port = address.rsplit(":", 1)
    return f"tcp://[{host}]:{port}" if ":" in host else f"tcp://{address}"


def find_rendezvous(env: Mapping[str, str] = os.environ
                    ) -> Optional[Rendezvous]:
    """The group a launcher describes in ``env``, or None where none
    does. In order: torchrun's LAUNCHER_ENV; Open MPI's mpirun
    (OMPI_MCA_orte_hnp_uri and OMPI_COMM_WORLD_{SIZE,RANK,LOCAL_RANK});
    SLURM's srun (SLURM_JOB_ID, SLURM_STEP_NODELIST, SLURM_NTASKS,
    SLURM_PROCID, SLURM_LOCALID): jax's order, and its coordinators.
    Raises where a launcher's variables are only partly there, and under
    PRTE_LAUNCHED (Open MPI 5) alone, which names no coordinator."""
    if any(v in env for v in LAUNCHER_ENV):
        _need(env, LAUNCHER_ENV, "torchrun")
        return Rendezvous("torchrun", "env://", int(env["WORLD_SIZE"]),
                          int(env["RANK"]), int(env["LOCAL_RANK"]))
    if OMPI_ENV[0] in env:
        _need(env, OMPI_ENV, "Open MPI")
        return Rendezvous("Open MPI", _tcp(ompi_coordinator(env)),
                          int(env["OMPI_COMM_WORLD_SIZE"]),
                          int(env["OMPI_COMM_WORLD_RANK"]),
                          int(env["OMPI_COMM_WORLD_LOCAL_RANK"]))
    if SLURM_ENV[0] in env:
        _need(env, SLURM_ENV, "SLURM")
        return Rendezvous("SLURM", _tcp(slurm_coordinator(env)),
                          int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"]),
                          int(env["SLURM_LOCALID"]))
    if PRTE_MARKER in env:
        raise RuntimeError(
            f"{PRTE_MARKER} is set (Open MPI 5), which names no "
            f"coordinator. Export all of {', '.join(LAUNCHER_ENV)} on every "
            f"rank (torchrun does so) to name the group directly")
    return None


def initialize_distributed_if_requested(device: str = "cuda") -> bool:
    """Join the process group that a launcher describes
    (``find_rendezvous``); True if this process is (now) in one.

    torchrun exports RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT to every rank; under SLURM (``srun``) and Open MPI
    (``mpirun``, before version 5) the scheduler's own variables name
    the ranks, and rank 0's host serves the store at a port derived from
    the job id, as jax derives it. With no launcher this returns False
    and touches nothing; with a launcher's variables only partly set, or
    PRTE_LAUNCHED alone, it raises. ``device`` is the run's device type:
    ``cuda`` joins over NCCL on card LOCAL_RANK (made the current device,
    so that ``resolve_device("cuda")`` picks it), ``cpu`` over gloo.

    The derived port may be taken on a shared node. Rank 0 then fails to
    listen ("address already in use" in torch's DistNetworkError, raised
    here as a RuntimeError that names the port) and the other ranks wait
    for it until their timeout; export torchrun's five variables with a
    free MASTER_PORT instead."""
    if dist.is_initialized():
        return True
    found = find_rendezvous()
    if found is None:
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device(torch.device("cuda", found.local_rank))
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=found.init_method, world_size=found.world_size,
            rank=found.rank)
    except dist.DistNetworkError as e:
        raise RuntimeError(
            f"{found.launcher}: rank {found.rank} could not reach the store "
            f"at {found.init_method} ({e}); if its port is in use on that "
            f"host, export all of {', '.join(LAUNCHER_ENV)} with a free "
            f"MASTER_PORT") from e
    return True


def process_rank() -> int:
    """This process's rank in the initialized process group, else 0."""
    return dist.get_rank() if dist.is_initialized() else 0


def _sum_(x: Tensor, group) -> Tensor:
    """Sum ``x`` over ``group`` in place, as a collective of a step
    (``utils/graphs.collective``); returns x."""
    graphs.collective(lambda: dist.all_reduce(x, op=dist.ReduceOp.SUM,
                                              group=group))
    return x


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group. Each rank's result feeds its own loss, so the
    gradient of the global loss with respect to a rank's input is the sum
    of every rank's upstream gradient: the backward is the same sum."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        return _sum_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad: Tensor):
        return _sum_(grad.contiguous().clone(), ctx.group), None


class DataGroup:
    """This process's place on the data axis: ``rank``, ``world_size`` and
    the process ``group`` (None: the default group), with the collectives
    of a data-parallel step. ``device`` holds the small tensors of the
    flag and barrier collectives (a CUDA device under NCCL)."""

    def __init__(self, device: torch.device, group=None):
        self.device = torch.device(device)
        self.group = group
        self.rank = dist.get_rank(group)
        self.world_size = dist.get_world_size(group)

    @classmethod
    def current(cls, device: torch.device) -> Optional["DataGroup"]:
        """The default process group as a DataGroup, or None when this
        process is in none."""
        if not (dist.is_available() and dist.is_initialized()):
            return None
        return cls(device)

    def all_reduce_mean(self, x: Tensor) -> Tensor:
        """The mean of ``x`` over the ranks, differentiable: one sum
        all-reduce divided by the world size. With equal shards, the
        mean of every rank's batch moments is the global batch's; at world
        size 1 it returns ``x``'s values bit for bit."""
        return _AllReduceSum.apply(x, self.group) / self.world_size

    def average_gradients(self, params) -> None:
        """Replace every ``.grad`` of ``params`` by its mean over the
        ranks, in one flat all-reduce. Every rank backpropagates its own
        mean loss, so the mean of the ranks' gradients is the gradient of
        the global batch's mean loss. The ranks run one graph, so the same
        parameters have gradients on every rank."""
        self.reduce_gradients(params, self.world_size)

    def sum_gradients(self, params) -> None:
        """Replace every ``.grad`` of ``params`` by its sum over the ranks,
        in one flat all-reduce: under point parallelism each rank's loss is
        its share of the global loss (``parallel/sp.py``)."""
        self.reduce_gradients(params, 1)

    def reduce_gradients(self, params, divisor: int) -> None:
        """Replace every ``.grad`` of ``params`` by its sum over the ranks
        divided by ``divisor``, in one flat all-reduce (DP x SP divides
        the sum over every rank by the batch axis's size). The gradients
        are reduced in f32 whatever their dtype: bf16 gradients (of bf16
        master weights) are upcast exactly, summed (and scaled) in f32,
        and each result is rounded back to its gradient's dtype to nearest
        even, the rounding of ``Tensor.copy_``."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = _sum_(torch.cat([g.reshape(-1).float() for g in grads]),
                     self.group)
        if divisor != 1:
            flat.div_(divisor)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def sum_(self, x: Tensor) -> Tensor:
        """Sum ``x`` over the ranks in place (no gradient); returns x."""
        return _sum_(x, self.group)

    def any(self, flag: bool) -> bool:
        """True on every rank if ``flag`` is true on any (a max
        all-reduce; the host waits for it)."""
        t = torch.tensor([float(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item() > 0)

    def broadcast_(self, x: Tensor, src: int = 0) -> Tensor:
        """Overwrite ``x`` with rank ``src``'s (of this group) in place;
        returns x."""
        if self.group is not None:
            src = dist.get_global_rank(self.group, src)
        dist.broadcast(x, src=src, group=self.group)
        return x

    def barrier(self) -> None:
        """Wait until every rank has arrived (an all-reduce, which both
        backends run on the group's device)."""
        self.any(False)


class ProcessMesh:
    """This process's place on the (data, model) grid of the ranks of the
    default process group: ``world`` (every rank), ``data`` (the ranks of
    this model index, which hold the same model slices or point shards
    and split the batch) and ``model`` (the ranks of this data index,
    which split the decoder's FC layers or the points; None at m = 1),
    each a ``DataGroup``; ``data_index`` d and ``model_index`` t with
    world rank d*m + t, and ``shape`` {DATA_AXIS: k/m, MODEL_AXIS: m}.

    At ``model_parallel`` 1 the data group is the default group itself.
    Otherwise every rank creates every subgroup, in one order (all data
    groups, then all model groups): ``torch.distributed.new_group`` is a
    collective of the whole world, and a rank that created another group,
    or one in another order, would hang the others."""

    def __init__(self, device: torch.device, model_parallel: int = 1):
        self.world = DataGroup(device)
        m = model_parallel
        if m < 1 or self.world.world_size % m:
            raise ValueError(
                f"model_parallel={m} does not divide the "
                f"{self.world.world_size} ranks of the process group")
        d = self.world.world_size // m
        self.shape = {DATA_AXIS: d, MODEL_AXIS: m}
        self.data_index, self.model_index = divmod(self.world.rank, m)
        if m == 1:
            self.data, self.model = self.world, None
            return
        data_groups = [dist.new_group([i * m + t for i in range(d)])
                       for t in range(m)]
        model_groups = [dist.new_group([i * m + t for t in range(m)])
                        for i in range(d)]
        self.data = DataGroup(device, data_groups[self.model_index])
        self.model = DataGroup(device, model_groups[self.data_index])

    @classmethod
    def current(cls, device: torch.device,
                model_parallel: int = 1) -> Optional["ProcessMesh"]:
        """The grid of the default process group, or None when this
        process is in none."""
        if not (dist.is_available() and dist.is_initialized()):
            return None
        return cls(device, model_parallel)

    def group(self, axis: str) -> Optional[DataGroup]:
        """The group along ``axis`` (DATA_AXIS or MODEL_AXIS)."""
        if axis not in self.shape:
            raise ValueError(f"unknown mesh axis {axis!r}; the axes are "
                             f"{DATA_AXIS!r} and {MODEL_AXIS!r}")
        return self.data if axis == DATA_AXIS else self.model

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        self.group(axis)
        return self.data_index if axis == DATA_AXIS else self.model_index


def _rank_entry(local_rank: int, fn: Callable, mesh: List[torch.device],
                backend: str, init_method: str, args: tuple) -> None:
    """One spawned rank: its device, its share of the host's cores on the
    CPU, the process group, then ``fn(device, *args)``."""
    device = mesh[local_rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(mesh)))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=len(mesh), rank=local_rank)
    try:
        fn(device, *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, data_parallel: Optional[int] = None,
           devices: Optional[Sequence] = None,
           backend: Optional[str] = None, args: tuple = (),
           init_method: Optional[str] = None) -> None:
    """Run ``fn(device, *args)`` in k local processes, one per device of
    ``make_mesh(devices, data_parallel)``, each rank in one process group;
    returns when all have finished, and raises if any rank failed (the
    others are then terminated).

    The processes start with the ``spawn`` method, so ``fn`` and ``args``
    must pickle (``fn`` a module-level function). ``backend`` defaults to
    ``nccl`` on cards and ``gloo`` on the CPU; ``gloo`` may be asked for on
    cards, and must be where two ranks share one (NCCL refuses that). The
    ranks meet through ``init_method``, by default a file store in a fresh
    temporary directory."""
    mesh = make_mesh(devices, data_parallel)
    if backend is None:
        backend = "nccl" if mesh[0].type == "cuda" else "gloo"
    if backend == "nccl" and len(set(mesh)) < len(mesh):
        raise ValueError(f"NCCL refuses two ranks on one device "
                         f"({[str(d) for d in mesh]}); use backend='gloo'")
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="pcae-dp-")
        init_method = "file://" + os.path.join(tmp, "store")
    try:
        torch.multiprocessing.start_processes(
            _rank_entry, args=(fn, mesh, backend, init_method, tuple(args)),
            nprocs=len(mesh), join=True, start_method="spawn")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
