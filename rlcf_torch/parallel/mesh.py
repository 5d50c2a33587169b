"""Process groups for episode data parallelism (dp) and class/gallery tensor
parallelism (tp): the counterpart of ``rlcf_tpu/parallel/mesh.py``.

TTA episodes are embarrassingly parallel (every episode starts from the same
weights), so the primary axis is **dp**: each rank runs whole episodes on its
slice of a group, and the group's outputs are gathered in episode order. The
secondary **tp** axis splits the long class or gallery axis (1000 prompts,
~25k captions): each rank encodes its share and the features or score
columns are gathered for selection, top-k and the rewards.

JAX runs the mesh from one process that sees every device, and GSPMD inserts
the collectives. Here each rank is a process (launched by ``torchrun``) that
runs an ordinary local program on its own card, with its hand-written
kernels, and the collectives are explicit (``parallel/collectives.py``).
NCCL carries them when each rank has a card of its own; gloo on the CPU and
when ranks share a card (NCCL refuses two ranks on one device; gloo moves CUDA
tensors for all_gather, all_reduce and broadcast).

Ranks lay out as JAX lays out devices: ``arange(world).reshape(dp, tp)``, tp
the fast axis. JAX's ``episode_shardings`` / ``shard_batched_episode`` are
jit placement; their counterpart is to run the batched episode on
``dp_slice`` of the batch and ``dp_gather`` the outputs.

Launch, e.g. on the CPU:
  torchrun --standalone --nproc_per_node 4 -m rlcf_torch.cli.tta_cls --device cpu --tp 2 ...
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0

# what init_distributed chose for this process
_STATE = {"device": None, "backend": None, "ranks_per_device": 1}


def _launch_hint(n: int) -> str:
    return f"launch one process per rank: torchrun --standalone --nproc_per_node {n} -m <entry point> ..."


def init_distributed(device: str = "cuda", init_method: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> bool:
    """Join the process group a launcher describes (the counterpart of
    ``maybe_initialize_distributed``): torchrun's ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT`` (or ``init_method``,
    e.g. a ``file://`` path). Without them it does nothing and returns False.

    The rank's device is ``cuda:{LOCAL_RANK % device_count}`` (``device``
    "cuda") or the CPU; the backend is NCCL when each rank has a card of its
    own, gloo on the CPU or when ranks share a card. Rank 0 prints the choice.
    ``timeout_s`` bounds every collective's wait (default 600 s)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return False
    if init_method is None and not ("MASTER_ADDR" in env and "MASTER_PORT" in env):
        return False
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available (pass device='cpu')")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
        shared = local_world > n_cards
        backend = "gloo" if shared else "nccl"
        per_device = sum(1 for r in range(local_world) if r % n_cards == local % n_cards)
    else:
        dev, backend, per_device, shared = torch.device("cpu"), "gloo", 1, False
    timeout = datetime.timedelta(seconds=timeout_s or DEFAULT_TIMEOUT_S)
    kw = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=world,
                            timeout=timeout, **kw)
    _STATE.update(device=dev, backend=backend, ranks_per_device=per_device)
    if rank == 0:
        why = ("ranks share a card" if shared else "a card per rank") if dev.type == "cuda" else "on the CPU"
        print(f"distributed: {world} ranks, backend {backend} ({why})", flush=True)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_rank() -> bool:
    """True in a single process and on rank 0: the rank that prints, logs and writes."""
    return rank() == 0


def backend() -> Optional[str]:
    return _STATE["backend"]


def ranks_per_device() -> int:
    """How many ranks of this host share this rank's card (1 without a
    launcher): the share of the card's memory a rank may plan for is 1 over it."""
    return _STATE["ranks_per_device"]


@dataclasses.dataclass
class Mesh:
    """A (dp, tp) layout of the running processes: this rank's coordinates
    and one process group for each axis (None for an axis of size 1)."""

    dp: int
    tp: int
    dp_rank: int = 0
    tp_rank: int = 0
    dp_group: Any = None
    tp_group: Any = None

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    def tiles_dp(self, n: int) -> bool:
        return n % self.dp == 0


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """A (dp, tp) mesh over the ``n_devices`` running processes (the
    counterpart of ``make_mesh``): ranks ``arange(n).reshape(dp, tp)``.

    Raises a descriptive ``ValueError`` when the request cannot be met (more
    processes asked for than run, or ``dp * tp`` not matching), naming how
    to launch. Every rank must call it, in the same order (the groups are
    made collectively)."""
    init_distributed("cuda" if torch.cuda.is_available() else "cpu")
    world = world_size()
    if n_devices is not None and n_devices > world:
        raise ValueError(f"make_mesh: {n_devices} processes requested but only {world} visible; "
                         + _launch_hint(n_devices))
    if n_devices is not None and n_devices < world:
        raise ValueError(f"make_mesh: {n_devices} processes requested but {world} visible; every process is a "
                         f"rank of the mesh: {_launch_hint(n_devices)}")
    n = world
    if dp is None:
        if n % tp != 0:
            raise ValueError(f"make_mesh: tp={tp} does not divide the {n} visible processes; pick tp from the "
                             f"divisors of {n}, or {_launch_hint(tp)}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"make_mesh: dp({dp}) * tp({tp}) != processes({n}); dp and tp must factor the process "
                         f"count exactly: {_launch_hint(dp * tp)}")
    if n == 1:
        return Mesh(1, 1)
    grid = np.arange(n).reshape(dp, tp)
    me = rank()
    (dp_rank,), (tp_rank,) = np.nonzero(grid == me)
    dp_group = tp_group = None
    for i in range(dp):   # every rank makes every group, in one order
        g = dist.new_group([int(r) for r in grid[i]]) if tp > 1 else None
        if i == dp_rank:
            tp_group = g
    for j in range(tp):
        g = dist.new_group([int(r) for r in grid[:, j]]) if dp > 1 else None
        if j == tp_rank:
            dp_group = g
    return Mesh(dp, tp, int(dp_rank), int(tp_rank), dp_group, tp_group)


def round_to_dp(group_size: int, mesh) -> int:
    """Round an episode-group size up to a multiple of the mesh's dp axis."""
    if mesh is None:
        return group_size
    dp = mesh.dp
    return max(dp, -(-group_size // dp) * dp)


_dp_slice_warned: set = set()


def dp_slice(mesh, x):
    """This rank's rows of a batch when its size tiles dp (the counterpart of
    ``dp_put``); otherwise the whole batch, every rank running all of it,
    with a NOTE once per (batch size, dp) shape."""
    if mesh is None or mesh.dp == 1:
        return x
    n = x.shape[0]
    if n % mesh.dp:
        if (n, mesh.dp) not in _dp_slice_warned:
            _dp_slice_warned.add((n, mesh.dp))
            print(f"NOTE: dp_slice: batch of {n} does not tile dp={mesh.dp}; running UNSHARDED (every rank runs "
                  f"the whole batch). Round the episode group to a multiple of dp (e.g. --episode_group "
                  f"{max(mesh.dp, n // mesh.dp * mesh.dp)}).", file=sys.stderr)
        return x
    k = n // mesh.dp
    return x[mesh.dp_rank * k:(mesh.dp_rank + 1) * k]


def dp_gather(mesh, x, n: Optional[int] = None):
    """The episode order restored on every rank: this rank's rows gathered
    over dp along axis 0. ``n``, the whole batch's size, passes through a
    batch that ``dp_slice`` left whole. A list gathers as objects."""
    from .collectives import gather_objects, gather_replicated

    if mesh is None or mesh.dp_group is None or (n is not None and not mesh.tiles_dp(n)):
        return x
    if isinstance(x, list):
        return gather_objects(x, mesh.dp_group)
    return gather_replicated(x, mesh.dp_group)


def shard_range(size: int, parts: int, index: int):
    """[lo, hi) of part ``index`` of ``size`` rows split into ``parts`` equal parts."""
    k = size // parts
    return index * k, (index + 1) * k


def class_sharded(mesh, x, axis: int = 0):
    """This tp rank's part of ``x`` along its class/gallery ``axis`` (the
    counterpart of ``class_sharded``); ``x`` whole without a tp axis."""
    if mesh is None or mesh.tp == 1:
        return x
    if x.shape[axis] % mesh.tp:
        raise ValueError(f"class_sharded: axis {axis} of size {x.shape[axis]} does not tile tp={mesh.tp}")
    lo, hi = shard_range(x.shape[axis], mesh.tp, mesh.tp_rank)
    return x.narrow(axis, lo, hi - lo)


def replicate(mesh, tree):
    """Every rank holds rank 0's values of ``tree``'s tensors (the counterpart
    of ``replicate``): a broadcast over the world, in place."""
    from ..core.policy import tree_leaves

    if mesh is None or world_size() == 1:
        return tree
    for leaf in tree_leaves(tree):
        if torch.is_tensor(leaf):
            dist.broadcast(leaf.data, src=0)
    return tree


def barrier():
    """Wait for every rank (nothing in a single process)."""
    if dist.is_initialized():
        dist.barrier()
