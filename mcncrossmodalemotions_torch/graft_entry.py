"""Driver integration: a single-card forward check and a multi-rank dry run.

Port of ``__graft_entry__.py``, whose names and structure it follows.

``entry(device="cuda")`` returns the flagship forward (waveform -> K1
frontend -> full-width VGG-M student, eval mode) with example arguments:
all-zero parameters and running statistics, as JAX's ``eval_shape`` and
zeros, and a batch of 8 four-second crops.

``dryrun_multichip(n)`` runs the framework's whole parallelism story on
tiny shapes in ``n`` rank processes joined by ``torch.distributed``
(``parallel/mesh.py``): one sharded SGD step, one fused online-distillation
step, ``Trainer.fit`` for two epochs with a ragged final batch and a
checkpoint each epoch, and a fresh ``Trainer`` that resumes for a third.
The reference's only parallelism is synchronous data parallelism (MATLAB
SPMD workers and a gradient-summing ParameterServer,
run_distillation.m:88,179,181), so one data-parallel rank a card is the
faithful equivalent. Each rank holds its state bitwise equal to every
other rank's after each stage (an all-reduce of a checksum) and raises on
any failed check; the parent raises with the first failing rank's error.

    python -m mcncrossmodalemotions_torch.graft_entry [--device cuda|cpu] \\
        [--ranks N] [--backend nccl|gloo]

On the card the ranks are one NCCL rank a card (``--ranks`` defaults to
the card count); ``--backend gloo`` lets ranks share cards. On the CPU the
backend is gloo and ``--ranks`` defaults to 8, the JAX main's 8 virtual
devices.
"""

from __future__ import annotations

import argparse
import faulthandler
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch
from torch import nn

from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC
from mcncrossmodalemotions_torch.utils.device import resolve_device

PACKAGE_PARENT = str(Path(__file__).resolve().parents[1])
ENTRY_BATCH = 8
ENTRY_FRAMES = 400            # 4 s crops
TINY_FRAMES = 100             # the dry run's 1 s crops
WORKER_TIMEOUT = 600          # seconds a rank may take
CPU_THREADS = 2               # torch threads of a rank on the CPU


def entry(device: torch.device | str = "cuda"):
    """(forward, example_args): the flagship forward on one device."""
    from torch.func import functional_call

    from mcncrossmodalemotions_torch.zoo import build_student

    device = resolve_device(device, "entry")
    model = build_student("emovoxceleb-student").to(device).eval()
    wav = torch.from_numpy(
        np.random.RandomState(0)
        .randn(ENTRY_BATCH, DEFAULT_SPEC.crop_samples(ENTRY_FRAMES))
        .astype(np.float32)).to(device)
    variables = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}

    def forward(variables, wav):
        with torch.no_grad():
            return functional_call(model, variables, (wav,),
                                   {"train": False})

    return forward, (variables, wav)


# -- the dry run ------------------------------------------------------------

def batch_rows(n_ranks: int) -> tuple:
    """(global batch, samples an epoch of the fit): two full batches and
    one ragged batch of ``max(n, 1)`` rows."""
    batch = 2 * n_ranks
    return batch, 2 * batch + max(batch // 2, 1)


class GrayTeacher(nn.Module):
    """The JAX dry run's ``teacher_apply``: gray uint8 frames as float,
    repeated to 3 channels, into the bare teacher."""

    def __init__(self, teacher: nn.Module):
        super().__init__()
        self.teacher = teacher

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.teacher(x.float().expand(-1, -1, -1, 3), train=train)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _agree(state, mesh, stage: str) -> str:
    """This rank's state digest (weights, running statistics, velocity and
    step, bit for bit), held equal to every rank's through an all-reduce
    of the ranks' digests (``gather_rows``); raises where one differs."""
    from mcncrossmodalemotions_torch.parallel.mesh import gather_rows

    h = hashlib.sha256(str(state.step).encode())
    for t in (list(state.model.state_dict().values())
              + list(state.velocity.values())):
        h.update(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8)
                 .numpy().tobytes())
    words = np.frombuffer(h.digest(), dtype=np.int64).copy()
    mine = torch.from_numpy(words).reshape(1, -1).to(mesh.device)
    every = gather_rows(mine, mesh).cpu()
    differ = [r for r in range(mesh.world_size)
              if not torch.equal(every[r], every[mesh.rank])]
    _require(not differ, f"rank {mesh.rank}: the state after {stage} differs "
                         f"from rank(s) {differ}'s")
    return h.hexdigest()


def _dryrun_impl(mesh, exp_dir: str, say: Callable[[str], None]) -> dict:
    """The four checks on this rank of ``mesh``; returns what it saw."""
    from mcncrossmodalemotions_torch.ops import _ffi
    from mcncrossmodalemotions_torch.parallel.mesh import shard_batch
    from mcncrossmodalemotions_torch.train import checkpoints as ckpt_lib
    from mcncrossmodalemotions_torch.train.distill import (
        make_online_distill_step,
    )
    from mcncrossmodalemotions_torch.train.engine import TrainConfig, Trainer
    from mcncrossmodalemotions_torch.tools import K1_K2, kernel_launches
    from mcncrossmodalemotions_torch.train.state import (
        SGDConfig,
        TrainState,
        make_train_step,
    )
    from mcncrossmodalemotions_torch.zoo import (
        build_student,
        build_teacher,
        student_loss_fn,
    )

    n_devices, dev = mesh.world_size, mesh.device
    _ffi.reset(K1_K2)
    digests, seconds = [], {}

    def on_device(batch):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in shard_batch(batch, mesh).items()}

    # tiny shapes: 1 s crops (100 spectrogram frames), tiny student widths
    crop = DEFAULT_SPEC.crop_samples(TINY_FRAMES)
    batch_size, n = batch_rows(n_devices)
    rng = np.random.RandomState(0)
    batch = {"data": rng.randn(batch_size, crop).astype(np.float32),
             "logit_target": rng.randn(batch_size, 8).astype(np.float32),
             "max_label": rng.randint(0, 8, batch_size)}
    model = build_student("emovoxceleb-student", tiny=True,
                          generator=torch.Generator().manual_seed(0))
    state = TrainState.create(model.to(dev),
                              torch.Generator(device=dev).manual_seed(1))
    loss_fn = student_loss_fn("hot-cross-ent", temperature=2.0)
    step = make_train_step(loss_fn, SGDConfig(weight_decay=0.0), mesh=mesh)
    t0 = time.perf_counter()
    state, metrics = step(state, on_device(batch), 1e-4)
    loss = float(metrics["loss"])
    seconds["step"] = time.perf_counter() - t0
    _require(bool(np.isfinite(loss)), f"non-finite loss {loss}")
    _require(state.step == 1, f"step {state.step} after one step")
    digests.append(_agree(state, mesh, "the SGD step"))
    say(f"dryrun_multichip({n_devices}): ok, loss={loss:.4f}")

    # the fused online-distillation step over the same mesh: the frozen
    # tiny teacher scores each rank's crops' face frames inside the step
    teacher = build_teacher("senet50-ferplus", tiny=True)
    teacher.reset_parameters(torch.Generator().manual_seed(2))
    frames = rng.randint(0, 255, (batch_size, 2, 32, 32, 1)).astype(np.uint8)
    fused = make_online_distill_step(
        GrayTeacher(teacher).to(dev), loss_type="hot-cross-ent",
        temperature=2.0, aggregator="max", sgd=SGDConfig(weight_decay=0.0),
        mesh=mesh)
    t0 = time.perf_counter()
    state, metrics = fused(state, on_device({"data": batch["data"],
                                             "frames": frames}), 1e-4)
    loss2 = float(metrics["loss"])
    seconds["fused"] = time.perf_counter() - t0
    _require(bool(np.isfinite(loss2)), f"non-finite fused loss {loss2}")
    _require(state.step == 2, f"step {state.step} after the fused step")
    digests.append(_agree(state, mesh, "the fused online step"))
    say(f"dryrun_multichip({n_devices}): fused online step ok, "
        f"loss={loss2:.4f}")

    # the training loop under the mesh: Trainer.fit with its prefetch
    # thread, a ragged final batch and a checkpoint each epoch, then a
    # fresh trainer resuming the run for a third epoch
    fit_data = rng.randn(n, crop).astype(np.float32)
    fit_targets = (rng.randn(n, 8) * 2).astype(np.float32)
    fit_labels = fit_targets.argmax(-1).astype(np.int64)

    def batches_fn(epoch):
        for k in range(0, n, batch_size):
            yield {"data": fit_data[k:k + batch_size],
                   "logit_target": fit_targets[k:k + batch_size],
                   "max_label": fit_labels[k:k + batch_size]}

    kw = dict(batch_size=batch_size, learning_rate=0.01, weight_decay=0.0,
              log_every=1000, exp_dir=exp_dir)
    t0 = time.perf_counter()
    trainer = Trainer(build_student("emovoxceleb-student", tiny=True),
                      loss_fn, TrainConfig(num_epochs=2, **kw), mesh=mesh)
    fit_state, history = trainer.fit(batches_fn)
    seconds["fit"] = time.perf_counter() - t0
    _require([h["epoch"] for h in history] == [1, 2],
             f"epochs {[h['epoch'] for h in history]}, not [1, 2]")
    checkpoints = len(ckpt_lib.list_checkpoints(exp_dir))
    _require(checkpoints == 2, f"{checkpoints} checkpoints, not 2")
    losses = [h["train"]["loss"] for h in history]
    _require(all(np.isfinite(losses)), f"non-finite fit losses {losses}")
    # the ragged tail accounted exactly: every epoch saw all n samples
    samples = [h["train"]["num_samples"] for h in history]
    _require(samples == [n, n], f"samples an epoch {samples}, not {n}")
    digests.append(_agree(fit_state, mesh, "Trainer.fit"))
    say(f"dryrun_multichip({n_devices}): Trainer.fit 2 epochs ok "
        f"(3 batches/epoch incl. ragged tail, losses="
        f"{[round(l, 4) for l in losses]})")

    t0 = time.perf_counter()
    resumed = Trainer(build_student("emovoxceleb-student", tiny=True),
                      loss_fn, TrainConfig(num_epochs=3, **kw), mesh=mesh)
    fit_state, history = resumed.fit(batches_fn)
    seconds["resume"] = time.perf_counter() - t0
    _require([h["epoch"] for h in history] == [3],
             "resume must continue at epoch 3, not restart")
    _require(fit_state.step == 9, f"step {fit_state.step} after 3 epochs "
                                  "of 3 batches, not 9")
    resume_loss = history[0]["train"]["loss"]
    digests.append(_agree(fit_state, mesh, "the resumed epoch"))
    say(f"dryrun_multichip({n_devices}): checkpoint resume -> epoch 3 ok, "
        f"loss={resume_loss:.4f}")
    return {"rank": mesh.rank, "device": str(dev),
            "losses": {"step": loss, "fused": loss2, "fit": losses,
                       "resume": resume_loss},
            "digests": digests, "seconds": seconds,
            "launches": kernel_launches()}


def _worker(argv: List[str]) -> int:
    """One rank: ``--worker <rank> <world> <port> <out.json> <exp_dir>
    <device> <backend>``. Joins the group on ``127.0.0.1:<port>``, runs the
    four checks and writes what it saw to ``out.json``."""
    import torch.distributed as dist

    from mcncrossmodalemotions_torch.parallel.mesh import (
        initialize_multihost,
        make_mesh,
    )

    rank, world, port = (int(a) for a in argv[:3])
    out, exp_dir, device, backend = Path(argv[3]), argv[4], argv[5], argv[6]
    faulthandler.dump_traceback_later(WORKER_TIMEOUT, exit=True)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(CPU_THREADS)
    address = f"127.0.0.1:{port}"
    if world == 1:  # initialize_multihost joins no group for one process
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method=f"tcp://{address}",
                                world_size=1, rank=0)
    else:
        initialize_multihost(address, world, rank, backend=backend)
    mesh = make_mesh(world, device=device)

    def say(line: str) -> None:
        if rank == 0:
            print(line, flush=True)

    result = _dryrun_impl(mesh, exp_dir, say)
    result["backend"] = dist.get_backend()
    out.write_text(json.dumps(result))
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:  # bind-then-close: a race the retry covers
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(command: Callable[[int, int], List[str]], n: int,
                work: Path, env: Optional[Callable[[int], dict]] = None,
                timeout: float = WORKER_TIMEOUT + 60) -> List[str]:
    """Run ``command(rank, port)`` for each of ``n`` ranks to their end (in
the environment ``env(rank)``, else this one's; their output under
``work``) and return each rank's standard output. When a rank exits non-zero the
    others get a few seconds to end before they are killed, and this
    raises with the first failing rank's standard error; a timeout kills
    them all and raises. A run is started again, on another port, only
    after a failure that says the port was taken."""
    for attempt in range(3):
        port = _free_port()
        logs = [(work / f"rank{r}.out", work / f"rank{r}.err")
                for r in range(n)]
        procs = []
        for r in range(n):
            with open(logs[r][0], "wb") as out, open(logs[r][1], "wb") as err:
                procs.append(subprocess.Popen(command(r, port), stdout=out,
                                              stderr=err,
                                              env=env(r) if env else None,
                                              cwd=PACKAGE_PARENT))
        failed, kill_at = None, None
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                now = time.monotonic()
                if failed is None:
                    failed = next((r for r, p in enumerate(procs)
                                   if p.poll() not in (None, 0)), None)
                    if failed is not None:
                        kill_at = now + 10.0
                if now > deadline or (kill_at is not None and now > kill_at):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.returncode),
                          None)
        if failed is None:
            return [logs[r][0].read_text(errors="replace") for r in range(n)]
        errs = [logs[r][1].read_text(errors="replace") for r in range(n)]
        if time.monotonic() > deadline:
            raise TimeoutError(f"{n} rank(s) did not end within {timeout} s; "
                               f"rank {failed}'s stderr:\n"
                               f"{errs[failed][-4000:]}")
        if attempt < 2 and any("address already in use" in e.lower()
                               for e in errs):
            continue
        raise RuntimeError(
            f"rank {failed} of {n} failed (exit {procs[failed].returncode}):"
            f"\n{errs[failed][-4000:]}")


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda",
                     backend: Optional[str] = None) -> List[dict]:
    """The dry run over ``n_devices`` rank processes; returns each rank's
    record (losses, state digests, seconds a stage, kernel launches).

    On the card each rank takes one card over NCCL by default, and more
    ranks than cards raises; ``backend="gloo"`` lets ranks share cards
    (rank r on card r mod count). On the CPU the backend is gloo. Each
    rank is ``python -m mcncrossmodalemotions_torch.graft_entry --worker
    ...``, a fresh process: this one may hold a CUDA context, which a
    fork cannot carry. Rank 0's lines are printed here.
    """
    device = resolve_device(device, "dryrun_multichip")
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        backend = backend or "nccl"
        if backend != "gloo" and n_devices > cards:
            raise ValueError(
                f"dryrun_multichip({n_devices}): {n_devices} NCCL ranks need "
                f"{n_devices} cards, this host has {cards}; pass "
                "backend='gloo' for ranks that share cards")
    else:
        cards = 1
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"dryrun_multichip on the CPU needs gloo, not "
                             f"{backend}")

    def env(rank: int) -> dict:
        e = dict(os.environ, LOCAL_RANK=str(rank % cards))
        e["PYTHONPATH"] = os.pathsep.join(
            [PACKAGE_PARENT] + ([e["PYTHONPATH"]] if e.get("PYTHONPATH")
                                else []))
        return e

    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        work = Path(tmp)

        def command(rank: int, port: int) -> List[str]:
            return [sys.executable, "-m", "mcncrossmodalemotions_torch."
                    "graft_entry", "--worker", str(rank), str(n_devices),
                    str(port), str(work / f"rank{rank}.json"),
                    str(work / "exp"), device.type, backend]

        outs = spawn_ranks(command, n_devices, work, env)
        sys.stdout.write(outs[0])
        return [json.loads((work / f"rank{r}.json").read_text())
                for r in range(n_devices)]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=None,
                    help="rank processes (default: the card count, or 8 on "
                         "the CPU)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    args = ap.parse_args(argv)
    fn, fn_args = entry(args.device)
    print("entry forward:", tuple(fn(*fn_args).shape), flush=True)
    ranks = args.ranks or (8 if args.device == "cpu"
                           else torch.cuda.device_count())
    dryrun_multichip(ranks, args.device, args.backend)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(_worker(sys.argv[2:]))
    sys.exit(main())
