"""Dry run of the multi-device paths: the port's copy of the JAX
``__graft_entry__.dryrun_multichip`` stages.

    python -m audio_to_sheet_music_tpu_torch.parallel.dryrun [N] [--device cuda|cpu]

1. The model: full width (the seeded init, seed 0), or ``init_tiny`` under
   ``ATSM_TINY_MODEL=1``.
2. One data-parallel train step over N spawned processes (the global
   batch of N items of 0.25 s split over the ranks, the head's gradients
   averaged by ``allreduce_mean_``) ...
3. ... equal to the single-device step on the global batch: the head's
   largest difference and the loss's under 1e-3, the JAX dry run's bounds.
4. ``Separator.separate_all`` of two stems with the chunk axis split over
   an N-entry mesh, against the single-device sweep (6 s chunks of a 12 s
   song at full width, 0.25 s chunks of 30000 samples at tiny width).

The command runs on the cards unless ``--device cpu`` asks for the host
(``dryrun_multichip``'s own default is the CPU, as the JAX dry run's
virtual devices are).  On the CPU the ranks join by gloo, the mesh's
entries are the host, the step and the sweep run in f32 and the sweep's
largest difference must be under 2e-3, the JAX dry run's bound.  On
``cuda`` rank ``r`` and mesh entry ``r`` take card ``r % count`` (NCCL when
each rank has a card of its own, else gloo, which all-reduces CUDA
tensors), in bf16 with the kernels (the step opt-in, the sweep default),
and the sweep is held to the kernel gate's 1e-3 rms: bf16 results depend
on the batch a chunk shares, so a largest difference says less there.

``spawn_ranks`` and ``dp_step`` are the pieces ``chip_smoke.py`` and the
tests reuse: processes joined through a ``file://`` rendezvous in a
temporary directory (no TCP port), each rank's return value pickled back
through a file.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SEED = 0
SAMPLE_RATE = 44100
HEAD_TOL = 1e-3           # the JAX dry run's head and loss bounds
SWEEP_TOL = 2e-3          # the JAX dry run's sweep bound
GATE_RMS = 1e-3           # ops.kernel_gate.RMS_THRESHOLD, the card's bound


def spawn_ranks(fn: Callable, world: int, *args) -> List[Any]:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` spawned
    processes; ``init_method`` is a ``file://`` rendezvous for
    ``parallel.init_data_parallel``.  Returns every rank's return value, in
    rank order.  ``fn`` must be importable by name (a module-level
    function)."""
    with tempfile.TemporaryDirectory(prefix="atsm_ranks_") as tmp:
        mp.spawn(_rank_main, args=(world, tmp, fn, args), nprocs=world,
                 join=True)
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]


def _rank_main(rank: int, world: int, tmp: str, fn: Callable,
               args: tuple) -> None:
    out = fn(rank, world, f"file://{tmp}/rendezvous", *args)
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def build_model(kind: str, device: str | torch.device = "cpu"):
    """``"tiny"``: ``atht.init_tiny(SEED)``; ``"full"``: ``atht.init(SEED)``
    (random head); ``"trained"``: ``atht.init(SEED)`` with the committed
    trained head; drawn on ``device``.  Every process that builds one gets
    the same weights."""
    from ..models import atht

    if kind == "tiny":
        return atht.init_tiny(SEED, device=device)
    if kind == "full":
        return atht.init(SEED, device=device)
    if kind == "trained":
        return atht.load_params(atht.init(SEED, device=device))
    raise ValueError(f"unknown model kind {kind!r}")


def make_batch(n: int, seconds: float, seed: int = SEED
               ) -> Dict[str, np.ndarray]:
    """A seeded host batch of ``n`` items of ``seconds`` (unit-normal
    mixture and target; the JAX dry run's fixed prompt ids)."""
    rng = np.random.default_rng(seed)
    t = int(seconds * SAMPLE_RATE)
    return {
        "mixture": rng.standard_normal((n, 2, t)).astype(np.float32),
        "target": rng.standard_normal((n, 2, t)).astype(np.float32),
        "input_ids": np.tile(np.array([0, 100, 7, 2], np.int64), (n, 1)),
        "attention_mask": np.ones((n, 4), np.int64),
    }


def _steps(model, batches: Sequence[Mapping[str, np.ndarray]], device,
           compute_dtype, kernels, data_parallel: bool, lo: int = 0,
           hi: int | None = None) -> Dict[str, Any]:
    """Train steps of ``model``'s head on ``batches`` (rows ``lo:hi`` of
    each) -> the head after them and the last step's metrics, on the
    host."""
    from ..ops.select import launch_counts
    from ..train.step import TrainState, make_optimizer, make_train_step
    from ..train.trainer import put_batch

    state = TrainState.create(model.to(device),
                              lambda p: make_optimizer(p, total_steps=10))
    step = make_train_step({}, compute_dtype, kernels, data_parallel)
    for raw in batches:
        metrics = step(state, put_batch(
            {k: v[lo:hi] for k, v in raw.items()}, device))
    return {"head": {k: v.detach().cpu().clone()
                     for k, v in model.head.state_dict().items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "launches": launch_counts()}


def _dp_rank(rank: int, world: int, init: str, devices: Sequence[str],
             backend: str, kind: str, batches, compute_dtype, kernels
             ) -> Dict[str, Any]:
    from .mesh import init_data_parallel

    device = torch.device(devices[rank])
    init_data_parallel(device, rank, world, init, backend)
    try:
        b = batches[0]["mixture"].shape[0]
        return _steps(build_model(kind, device), batches, device,
                      compute_dtype, kernels, True, rank * b // world,
                      (rank + 1) * b // world)
    finally:
        dist.destroy_process_group()


def max_delta(a: Mapping[str, torch.Tensor],
              b: Mapping[str, torch.Tensor]) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def dp_step(world: int, batches: Sequence[Mapping[str, np.ndarray]],
            devices: Sequence[str] | None = None, backend: str = "gloo",
            kind: str = "tiny", compute_dtype: torch.dtype = torch.float32,
            kernels="none") -> Dict[str, Any]:
    """``len(batches)`` data-parallel train steps over ``world`` spawned
    ranks (rank ``r`` on ``devices[r]``, default the CPU) against the same
    steps on one device (``devices[0]``, in this process) on the global
    batches, from the same weights (``build_model(kind)``).  Returns the
    head's largest difference (``head_delta``), the loss's
    (``loss_delta``), both sides' metrics and the seconds."""
    devices = list(devices or ["cpu"] * world)
    t0 = time.perf_counter()
    ranks = spawn_ranks(_dp_rank, world, devices, backend, kind,
                        list(batches), compute_dtype, kernels)
    t1 = time.perf_counter()
    single = _steps(build_model(kind, devices[0]), batches,
                    torch.device(devices[0]),
                    compute_dtype, kernels, False)
    dp = ranks[0]
    return {
        "head_delta": max_delta(dp["head"], single["head"]),
        "loss_delta": abs(dp["metrics"]["loss/total"]
                          - single["metrics"]["loss/total"]),
        "ranks_agree": all(max_delta(r["head"], dp["head"]) == 0.0
                           for r in ranks),
        "dp": dp, "single": single,
        "dp_seconds": t1 - t0, "single_seconds": time.perf_counter() - t1,
    }


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_devices: int, device: str = "cpu") -> Dict[str, Any]:
    """The four stages above; raises ``AssertionError`` if a check fails.
    Returns the numbers it printed."""
    from ..infer.session import Separator
    from .mesh import make_mesh

    t_start = time.perf_counter()

    def stage(msg: str) -> None:
        print(f"dryrun_multichip({n_devices}) "
              f"[{time.perf_counter() - t_start:7.1f}s] {msg}", flush=True)

    tiny = os.environ.get("ATSM_TINY_MODEL") == "1"
    kind = "tiny" if tiny else "full"
    cuda = torch.device(device).type == "cuda"
    if cuda:
        count = torch.cuda.device_count()
        devices = [f"cuda:{i % count}" for i in range(n_devices)]
        backend = "nccl" if n_devices <= count else "gloo"
        dtype, kernels = torch.bfloat16, "opt_in"
    else:
        devices = [device] * n_devices
        backend, dtype, kernels = "gloo", torch.float32, "none"
    stage(f"stage 1/4: {'tiny' if tiny else 'full-width'} model on "
          f"{devices}")

    stage(f"stage 2/4: data-parallel train step over {n_devices} "
          f"{backend} ranks, and 3/4: the single-device step")
    res = dp_step(n_devices, [make_batch(n_devices, 0.25)], devices,
                  backend, kind, dtype, kernels)
    loss = res["dp"]["metrics"]["loss/total"]
    _check(np.isfinite(loss), f"non-finite loss {loss}")
    _check(res["head_delta"] < HEAD_TOL,
           f"DP != single-device: head delta {res['head_delta']}")
    _check(res["loss_delta"] < HEAD_TOL,
           f"DP != single-device: loss delta {res['loss_delta']}")
    stage(f"train ok, loss={loss:.4f}, dp_delta={res['head_delta']:.2e}, "
          f"loss_delta={res['loss_delta']:.2e}")

    seg_s, ov_s, song_t = (0.25, 0.05, 30000) if tiny else (6.0, 1.5, 529200)
    stage(f"stage 4/4: sweep with the chunk axis split over a "
          f"{n_devices}-entry mesh (segment {seg_s} s)")
    model = build_model(kind, devices[0])
    kw = dict(segment_seconds=seg_s, overlap_seconds=ov_s,
              compute_dtype=None if cuda else torch.float32)
    sep = Separator(model, mesh=make_mesh(devices), **kw)
    song = (0.1 * np.random.default_rng(SEED).standard_normal(
        (2, song_t))).astype(np.float32)
    stems = sep.separate_all(song, stems=("drums", "vocals"))
    for s, stem in stems.items():
        _check(stem.shape == song.shape and np.isfinite(stem).all(),
               f"stem {s}: shape {stem.shape} or non-finite values")
    single = Separator(model, device=devices[0], **kw).separate_all(
        song, stems=("drums", "vocals"))
    sweep_delta = max(float(np.max(np.abs(stems[s] - single[s])))
                      for s in stems)
    sweep_rms = max(float(np.sqrt(np.mean((stems[s] - single[s]) ** 2)))
                    for s in stems)
    if cuda:
        _check(sweep_rms < GATE_RMS,
               f"sharded sweep != single-device: rms {sweep_rms}")
    else:
        _check(sweep_delta < SWEEP_TOL,
               f"sharded sweep != single-device: {sweep_delta}")
    stage(f"sweep ok: sharded == single-device (max delta "
          f"{sweep_delta:.2e}, rms {sweep_rms:.2e})")
    print(f"dryrun_multichip({n_devices}): ok, loss={loss:.4f}, "
          f"sweep_delta={sweep_delta:.2e}")
    return {"loss": loss, "head_delta": res["head_delta"],
            "loss_delta": res["loss_delta"], "sweep_delta": sweep_delta,
            "sweep_rms": sweep_rms, "devices": devices, "backend": backend}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="audio_to_sheet_music_tpu_torch.parallel.dryrun",
        description="Dry run of data-parallel training and the sharded "
                    "sweep")
    ap.add_argument("n_devices", nargs="?", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
