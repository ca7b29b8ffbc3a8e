"""Synchronous data parallelism over ``torch.distributed``.

Port of ``mcncrossmodalemotions_tpu/parallel/mesh.py``. The reference's
parallelism is synchronous data parallelism: MATLAB SPMD workers and a
ParameterServer summing the gradients (run_distillation.m:88,179-181). The
JAX package runs one program over a 1-D device mesh and lets XLA insert
the ``psum``. PyTorch's idiom is one process per card (``torchrun``, or
processes spawned by the caller), and the port follows it:

- every rank builds the same global host batch from the same seed, keeps
  its contiguous rows (``shard_batch``) and holds a full copy of the
  model, the velocity and the generator;
- a step sums the gradients over the ranks (one all-reduce of one flat
  buffer) before the SGD update, so every rank makes the same update;
- train-mode BatchNorm all-reduces its masked sums (``all_reduce_sum``,
  differentiable) and normalises with the statistics of the GLOBAL batch,
  as Flax's BatchNorm does under pjit;
- random draws (dropout, the teachers' fliplr) are made at the global
  batch's shape from the replicated generator, each rank keeping its rows,
  so the generators stay in lockstep as JAX's one replicated key does.

Collectives are ``all_reduce`` and nothing else (a gather is an all-reduce
of a zero-filled buffer in which each rank writes its rows): PyTorch's
gloo backend runs it on CUDA tensors too, so one code path serves gloo
(two ranks on one card, or the CPU) and NCCL (one card a rank).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mcncrossmodalemotions_torch.utils.device import resolve_device

DATA_AXIS = "data"


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank in the default group; 0 without one (the
    counterpart of ``jax.process_index``)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """Join the job's process group (``torch.distributed``).

    Call it once per process before ``make_mesh``. A job of one process
    needs no group: ``num_processes <= 1`` does nothing. Arguments left
    None are read from ``torchrun``'s environment (``MASTER_ADDR:
    MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), the counterpart of JAX's
    auto-detection on Cloud TPU. ``backend`` defaults to ``nccl`` where a
    CUDA device is present and to ``gloo`` on the CPU; two ranks that share
    one card pass ``gloo`` themselves (NCCL refuses two ranks on one
    device). Nothing switches backend on its own: a backend that cannot be
    initialised raises.
    """
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "initialize_multihost: pass coordinator_address ('host:port'), "
            "num_processes and process_id, or launch with torchrun (MASTER_"
            "ADDR, MASTER_PORT, WORLD_SIZE and RANK in the environment)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get(
            "LOCAL_RANK", process_id % torch.cuda.device_count())))
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This rank's view of a 1-D data-parallel mesh (the counterpart of a
    ``jax.sharding.Mesh`` with one ``DATA_AXIS``): its rank, the world
    size, the device its shard of every batch lives on and the process
    group the collectives run in."""

    rank: int
    world_size: int
    device: torch.device
    group: Any = None

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a batch of ``n`` rows; ``n``
        must split evenly (``pad_to_multiple``)."""
        if n % self.world_size:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{self.world_size} ranks; pad it first "
                             "(pad_to_multiple)")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)


def _rank_device(device: torch.device | str) -> torch.device:
    """``device`` for this rank: a bare ``"cuda"`` is the card of the
    rank's ``LOCAL_RANK`` (0 without one)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return resolve_device(device, "make_mesh")


def make_mesh(num_devices: Optional[int] = None,
              device: torch.device | str = "cuda") -> DataMesh:
    """The mesh over every rank of the default process group
    (``initialize_multihost`` first), this rank's shards on ``device``.

    ``num_devices`` states the expected world size: a group with fewer
    ranks raises (never train silently on a smaller mesh, the JAX rule),
    and so does one with more, since every rank of a job takes part.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no process group; call "
                           "initialize_multihost() (or launch with torchrun)")
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(
            f"make_mesh({num_devices}): the process group has {world} "
            "rank(s); check initialize_multihost / the torchrun launch "
            "(every rank of the job is in the mesh)")
    device = _rank_device(device)
    if dist.get_backend() == "nccl" and device.type != "cuda":
        raise ValueError(f"make_mesh: an NCCL group needs CUDA shards, "
                         f"not {device}")
    return DataMesh(rank=dist.get_rank(), world_size=world, device=device,
                    group=dist.group.WORLD)


def auto_mesh(batch_size: int,
              device: torch.device | str = "cuda") -> Optional[DataMesh]:
    """The mesh of a job's drivers (``mesh="auto"``): None in a single
    process, else every rank, which must split ``batch_size`` evenly.

    The JAX package shrinks its mesh to the largest device count that
    divides the batch; a ``torchrun`` job cannot leave ranks idle, so here
    a world size that does not divide the batch raises.
    """
    world = world_size()
    if world <= 1:
        return None
    if batch_size % world:
        raise ValueError(
            f"auto_mesh: a batch of {batch_size} does not split over "
            f"{world} ranks; choose a batch size that the world size "
            "divides (every rank takes an equal shard)")
    return make_mesh(device=device)


def shard_batch(batch: Dict[str, Any], mesh: DataMesh) -> Dict[str, Any]:
    """This rank's rows of a global host batch: every array (or tensor)
    whose leading dimension is ``batch["data"]``'s is cut to
    ``mesh.rows``; other entries are kept whole. Every rank builds the
    same global batch, as every JAX process does before ``device_put``
    with ``batch_sharding``."""
    n = batch["data"].shape[0]
    rows = mesh.rows(n)
    return {k: v[rows] if getattr(v, "ndim", 0) >= 1 and v.shape[0] == n
            else v for k, v in batch.items()}


def pad_to_multiple(batch: Dict[str, np.ndarray], multiple: int,
                    pad_key: str = "data"):
    """Pad the batch dim to a rank-count multiple; returns (batch, n_valid).

    Ragged final batches are padded by repeating the last row and the
    valid count carried for metric weighting. A caller-supplied
    ``pad_mask`` is padded with ZEROS (never by duplicating the last row's
    1.0): padding rows stay out of losses, metrics and BatchNorm, and
    ``n_valid`` counts the mask's valid rows.
    """
    n = batch[pad_key].shape[0]
    mask = batch.get("pad_mask")
    n_valid = int(np.sum(mask)) if mask is not None else n
    remainder = n % multiple
    if remainder == 0:
        return batch, n_valid
    pad = multiple - remainder
    padded = {
        k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n else v
        for k, v in batch.items()
    }
    if mask is not None:
        padded["pad_mask"] = np.concatenate(
            [np.asarray(mask, np.float32), np.zeros(pad, np.float32)])
    return padded, n_valid


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum of
    the ranks' gradients of the (replicated) output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable (the global BatchNorm's
    sums): every rank gets the same result, and in the backward every
    rank's ``x`` gets the sum of all ranks' gradients of it."""
    return _AllReduceSum.apply(x, mesh.group)


def all_reduce_tensors(tensors: Sequence[torch.Tensor],
                       mesh: DataMesh) -> List[torch.Tensor]:
    """Each tensor summed over the ranks, outside autograd: one collective
    for each dtype present, over one flat buffer (a step's gradients, its
    metrics). Returns new tensors shaped as the inputs."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    with torch.no_grad():
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, group=mesh.group)
            offset = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[offset:offset + n].view(tensors[i].shape)
                offset += n
    return out


def gather_rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's rows of ``x`` in rank order, on every rank: an
    all-reduce of a zero-filled buffer in which this rank wrote its rows
    (the JAX extractor's replicated ``out_shardings``). A value is kept
    bit for bit, a -0.0 becoming +0.0."""
    n = x.shape[0] * mesh.world_size
    out = x.new_zeros((n,) + tuple(x.shape[1:]))
    out[mesh.rows(n)] = x
    dist.all_reduce(out, group=mesh.group)
    return out


def barrier(mesh: DataMesh) -> None:
    """Return once every rank has reached here (an all-reduce read back on
    the host): after rank 0 writes a file the others will read."""
    flag = torch.ones(1, device=mesh.device)
    dist.all_reduce(flag, group=mesh.group)
    flag.item()
