"""Chunked dense teacher inference: bounded worker processes + resume.

Port of ``mcncrossmodalemotions_tpu/exp/dense_chunked.py``. The 5.08M-frame
EmoVoxCeleb dense build (fetch_emovoxceleb_imdb.m:119-136) runs for hours;
here no process lives longer than ``chunk_frames`` frames, so a process
that dies (or leaks host memory) loses at most one chunk, and the
fingerprinted partial checkpoint of ``VisualFeatureExtractor.frame_logits``
makes the cycle invisible to the result (bitwise: same batches, same
weights, same thread count and backend switches):

    supervisor (this process; no device work)
      └─ loop: spawn worker ─ python -m mcncrossmodalemotions_torch.exp.dense_chunked
               --worker job.json: at most chunk_frames NEW frames (whole
               batches) against the shared partial, flush, exit
         until a worker leaves the result; a cycle that makes no forward
         progress aborts.

The worker rebuilds its model from a JSON ``model_spec`` and computes with
the state the supervisor wrote (``torch.save`` of the CPU ``state_dict``,
read back with ``torch.load(weights_only=True)``), never with the weights
it loaded:

- ``{"pretrained": <registry name or .mat path>, "input_size": N}``: the
  production path, ``zoo.load_pretrained_teacher(with_pipeline=True)``;
- ``{"teacher": {<zoo.build_teacher kwargs>}, "input_size": N,
  "mean_rgb": [...]}``: a zoo-built ``FaceTeacherPipeline`` (the tiny
  configurations of the tests).

Either may carry ``"dtype": "float32"`` (or ``"bfloat16"``, the ResNets'
default) for the teacher's compute dtype, which is a module attribute and
not part of the state.

Reached through ``compute_visual_feats(..., max_frames_per_process=N)``,
``build_imdb(..., max_frames_per_process=N, teacher_spec=...)`` and ``cli
fetch-imdb chunk_frames=N``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

# the directory holding this package: a worker imports the supervisor's copy
# whatever the caller's working directory
PACKAGE_PARENT = str(Path(__file__).resolve().parents[2])
WORKER_MODULE = "mcncrossmodalemotions_torch.exp.dense_chunked"


def worker_frames(chunk_frames: int, batch_size: int) -> int:
    """New frames a worker takes: ``frame_logits(max_frames=)`` keeps whole
    batches, at least one."""
    return max(1, chunk_frames // batch_size) * batch_size


def max_worker_cycles(num_frames: int, chunk_frames: int,
                      batch_size: int) -> int:
    """The default cycle budget: the workers a healthy run needs, from the
    frames each really takes, plus two. (The JAX module divides by
    ``chunk_frames`` and so aborts healthy runs whose chunk is not a whole
    number of batches.)"""
    return -(-num_frames // worker_frames(chunk_frames, batch_size)) + 2


def worker_env(env: Optional[Mapping[str, str]] = None) -> dict:
    """The child's environment: ``env`` (else this process's) with this
    package's parent directory first on ``PYTHONPATH``."""
    env = dict(os.environ if env is None else env)
    paths = [PACKAGE_PARENT] + ([env["PYTHONPATH"]]
                                if env.get("PYTHONPATH") else [])
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env


def backend_switches() -> dict:
    """This process's switches that change what a conv or matmul computes;
    a worker sets the same."""
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def _set_backend_switches(switches: Mapping[str, bool]) -> None:
    torch.backends.cudnn.allow_tf32 = switches["cudnn_allow_tf32"]
    torch.backends.cudnn.deterministic = switches["cudnn_deterministic"]
    torch.backends.cuda.matmul.allow_tf32 = switches["matmul_allow_tf32"]


def build_worker_model(spec: Mapping, device: torch.device | str = "cuda"):
    """``(model, state or None)`` from a JSON model spec (the worker side);
    the worker computes with the supervisor's state either way."""
    if "pretrained" in spec:
        from mcncrossmodalemotions_torch.zoo import load_pretrained_teacher

        model, state = load_pretrained_teacher(
            spec["pretrained"], with_pipeline=True,
            input_size=int(spec.get("input_size", 224)),
            download=bool(spec.get("download", False)), device=device)
    else:
        from mcncrossmodalemotions_torch.models.teacher_pipeline import (
            FaceTeacherPipeline,
        )
        from mcncrossmodalemotions_torch.zoo import build_teacher

        kw = {"mean_rgb": tuple(spec["mean_rgb"])} if "mean_rgb" in spec else {}
        model = FaceTeacherPipeline(build_teacher(**spec["teacher"]),
                                    input_size=int(spec.get("input_size", 224)),
                                    augment=False, **kw).eval()
        state = None
    if "dtype" in spec:
        model.teacher.dtype = getattr(torch, spec["dtype"])
    return model, state


def _partial_rows(partial: Path) -> int:
    if not partial.exists():
        return 0
    with np.load(partial, allow_pickle=False) as data:
        return int(data["logits"].shape[0])


def _worker_main(job_file: str) -> int:
    """One bounded chunk of the dense pass, in THIS (fresh) process."""
    from mcncrossmodalemotions_torch.exp.compute_visual_feats import (
        VisualFeatureExtractor,
    )

    job = json.loads(Path(job_file).read_text())
    torch.set_num_threads(int(job["num_threads"]))
    _set_backend_switches(job["backends"])
    frames = Path(job["frames_file"]).read_text().splitlines()
    model, loaded = build_worker_model(job["model_spec"], job["device"])
    del loaded  # the supervisor's state below is the one computed with
    state = torch.load(job["state_file"], map_location="cpu",
                       weights_only=True)
    extractor = VisualFeatureExtractor(
        model, state, batch_size=int(job["batch_size"]),
        crop_ratio=float(job["crop_ratio"]),
        input_size=int(job["input_size"]), device=job["device"])
    result = extractor.frame_logits(
        frames, verbose=bool(job["verbose"]),
        partial_path=job["partial_path"],
        max_frames=int(job["chunk_frames"]))
    if result is not None:  # the job finished inside this worker's bound
        out = Path(job["out_path"])
        tmp = out.with_suffix(".tmp.npz")
        np.savez(tmp, logits=result)
        tmp.replace(out)
        done = len(frames)
    else:
        done = _partial_rows(Path(job["partial_path"]))
    print(json.dumps({"chunk_worker": "progress" if result is None
                      else "complete", "done": done, "total": len(frames)}),
          flush=True)
    return 0


def chunked_frame_logits(model_spec: Mapping,
                         state: Mapping[str, torch.Tensor],
                         frame_paths: Sequence[str],
                         partial_path: str, *,
                         chunk_frames: int,
                         batch_size: int = 128,
                         crop_ratio: float = 1.0,
                         input_size: int = 224,
                         verbose: bool = True,
                         env: Optional[Mapping[str, str]] = None,
                         device: torch.device | str = "cuda",
                         max_cycles: Optional[int] = None) -> np.ndarray:
    """[N, C] dense logits through bounded worker subprocesses.

    The same logits as ``VisualFeatureExtractor(model, state, ...)
    .frame_logits(frame_paths)`` in this process, bit for bit, but no
    process scores more than ``worker_frames(chunk_frames, batch_size)``
    frames. The job directory ``<partial>.job/`` holds the frame list,
    the state (copied to the host here: this process does no device work,
    so the first worker owns the card) and ``job.json`` with ``device``
    (the workers', the card unless the caller asks for ``"cpu"``), this
    process's thread count and backend switches; it is removed when the
    result is in. Each cycle runs ``python -m`` this module ``--worker``
    with ``env`` (else this environment) and this package first on
    ``PYTHONPATH``. A worker that exits non-zero raises with the tail of
    its output (the partial stays for a later call to resume); so does a
    cycle that makes no progress, and running out of ``max_cycles``
    (default ``max_worker_cycles``). With ``verbose`` the workers' output
    and one ``[dense-chunked] cycle`` line a cycle are printed.
    """
    if chunk_frames < 1:
        raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
    partial = Path(partial_path)
    partial.parent.mkdir(parents=True, exist_ok=True)
    job_dir = partial.with_suffix(".job")
    job_dir.mkdir(exist_ok=True)
    frames_file = job_dir / "frames.txt"
    frames_file.write_text("\n".join(map(str, frame_paths)))
    state_file = job_dir / "state.pt"
    torch.save({k: v.detach().to("cpu", copy=True).contiguous()
                for k, v in state.items()}, state_file)
    out_path = job_dir / "result.npz"
    out_path.unlink(missing_ok=True)
    job = {
        "model_spec": dict(model_spec),
        "frames_file": str(frames_file),
        "state_file": str(state_file),
        "partial_path": str(partial),
        "out_path": str(out_path),
        "chunk_frames": int(chunk_frames),
        "batch_size": int(batch_size),
        "crop_ratio": float(crop_ratio),
        "input_size": int(input_size),
        "verbose": bool(verbose),
        "device": str(device),
        "num_threads": torch.get_num_threads(),
        "backends": backend_switches(),
    }
    job_file = job_dir / "job.json"
    job_file.write_text(json.dumps(job))

    n = len(frame_paths)
    if max_cycles is None:
        max_cycles = max_worker_cycles(n, chunk_frames, batch_size)
    command = [sys.executable, "-m", WORKER_MODULE, "--worker", str(job_file)]
    child_env = worker_env(env)
    last_done = -1
    for cycle in range(1, max_cycles + 1):
        t0 = time.perf_counter()
        proc = subprocess.run(command, env=child_env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        seconds = time.perf_counter() - t0
        output = proc.stdout or ""
        if verbose and output:
            print(output, end="" if output.endswith("\n") else "\n",
                  flush=True)
        if proc.returncode != 0:
            tail = " | ".join(output.strip().splitlines()[-8:])
            raise RuntimeError(
                f"dense-chunked worker failed (cycle {cycle}, exit "
                f"{proc.returncode}): {tail}")
        finished = out_path.exists()
        done = n if finished else _partial_rows(partial)
        if verbose:
            print(f"[dense-chunked] cycle {cycle}: {done}/{n} frames, "
                  f"{seconds:.3f} s", flush=True)
        if finished:
            with np.load(out_path, allow_pickle=False) as data:
                result = data["logits"]
            for p in (frames_file, state_file, job_file, out_path):
                p.unlink(missing_ok=True)
            try:
                job_dir.rmdir()
            except OSError:  # something not ours is in it: leave it
                pass
            return result
        if done <= last_done:
            raise RuntimeError(
                f"dense-chunked made no progress (stuck at {done}/{n} "
                "frames); aborting instead of spinning")
        last_done = done
    raise RuntimeError(
        f"dense-chunked did not finish within {max_cycles} cycles "
        f"({last_done}/{n} frames)")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.exit(_worker_main(sys.argv[2]))
    print(f"usage: python -m {WORKER_MODULE} --worker <job.json>",
          file=sys.stderr)
    sys.exit(2)
