"""Mesh and data-parallel helpers: the port's counterpart of
``audio_to_sheet_music_tpu/parallel/mesh.py``.

The model (~170 M parameters, ~3 M of them the trainable head) fits one
card, so two axes scale, both as batch axes, as in the JAX package:

- inference: the chunk axis of a song's sweep.  A ``Mesh`` is a list of
  devices; ``infer.session.Separator(mesh=...)`` keeps one replica of the
  model per distinct device (``replicate``), splits each chunk group into
  ``mesh.size`` equal slices and runs each slice on its device.  A device
  may appear more than once: its replica then takes several slices, which
  is how a test puts several replicas on one device.
- training: the batch axis.  One process per device, each with its own
  rows of the same global batch; XLA's inserted gradient psum has no
  PyTorch counterpart, so ``allreduce_mean_`` averages the head's
  gradients with one all-reduce (``train.step.make_train_step(...,
  data_parallel=True)``).  ``init_data_parallel`` joins the process group:
  NCCL for a ``cuda`` device and gloo for ``cpu``, from the device alone.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["DATA_AXIS", "Mesh", "allreduce_mean_", "init_data_parallel",
           "make_mesh", "pad_to_multiple", "replicate", "shard_batch"]

DATA_AXIS = "data"        # the name of a mesh's one axis, as in the JAX mesh


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: the devices that take the slices of a batch axis,
    in order."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> List[torch.device]:
        """The mesh's devices without repeats, first seen first."""
        return list(dict.fromkeys(self.devices))


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices: Sequence[Any] | None = None) -> Mesh:
    """1-D data mesh over every visible card, or over ``devices`` (names or
    ``torch.device``s; repeats allowed)."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices= (for example ['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = tuple(_device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: no devices")
    return Mesh(devs)


def shard_batch(x: Any, mesh: Mesh) -> List[Any]:
    """Split axis 0 of ``x`` (a tensor, or a mapping of tensors) into
    ``mesh.size`` equal slices, slice ``i`` on ``mesh.devices[i]``: a list
    of per-device pieces of ``x``'s structure.  Raises unless axis 0
    divides evenly."""
    n = mesh.size

    def split(t: torch.Tensor) -> List[torch.Tensor]:
        if t.shape[0] % n:
            raise ValueError(f"shard_batch: axis 0 of {tuple(t.shape)} does "
                             f"not split into {n} equal slices")
        k = t.shape[0] // n
        return [t[i * k:(i + 1) * k].to(d, non_blocking=True)
                for i, d in enumerate(mesh.devices)]

    if isinstance(x, Mapping):
        parts = {key: split(v) for key, v in x.items()}
        return [{key: v[i] for key, v in parts.items()} for i in range(n)]
    return split(x)


def replicate(model: torch.nn.Module, mesh: Mesh
              ) -> Dict[torch.device, torch.nn.Module]:
    """One copy of ``model`` per distinct device of the mesh; the first
    device's is ``model`` itself, moved there."""
    first, *rest = mesh.distinct()
    out = {first: model.to(first)}
    for d in rest:
        out[d] = copy.deepcopy(model).to(d)
    return out


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def init_data_parallel(device: str | torch.device, rank: int | None = None,
                       world_size: int | None = None,
                       init_method: str | None = None,
                       backend: str | None = None) -> Tuple[int, int]:
    """Join the process group of a data-parallel run -> ``(rank, world)``.

    ``rank`` / ``world_size`` are ``torch.multiprocessing.spawn``'s (with an
    ``init_method`` such as ``file:///tmp/x`` or ``tcp://localhost:port``);
    left out, they come from ``RANK`` / ``WORLD_SIZE`` with ``env://``, as
    ``torchrun`` sets them.  The backend is NCCL for a ``cuda`` device and
    gloo for ``cpu``; ``backend="gloo"`` on a card runs several ranks on one
    card (NCCL takes one rank a card), where gloo all-reduces CUDA tensors
    itself.  A ``cuda`` device becomes the process's current device; on
    ``cpu`` the process takes its share of the host's cores (one process
    each taking all of them slows every rank several times over)."""
    device = torch.device(device)
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    if world_size is None or init_method is None:
        raise ValueError("init_data_parallel: a rank needs world_size and "
                         "init_method")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return rank, world_size


def allreduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average ``tensors`` (one dtype, one device) over the process group
    in place, with one all-reduce of their flattened concatenation."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n
