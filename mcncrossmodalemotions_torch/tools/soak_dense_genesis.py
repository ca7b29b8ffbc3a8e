"""Dataset-genesis soak: the dense teacher build at synthetic scale.

Port of ``tools/soak_dense_genesis.py``. It runs ``build_imdb``'s dense
pass (full-width SENet50 from ``zoo.random_teacher_variables(seed=0)``,
bf16, batch 128, on the card) over on-disk synthetic frames three times,
each build a fresh worker process (this module with ``--worker``), so the
kill is a real SIGKILL of a live run and the RSS is that process's own:

  1. clean: the uninterrupted build; frames/s and its RSS (``VmRSS``)
     sampled every 2 s, the growth after the build is 25% done and per
     batch;
  2. killed: the same job to a second output, SIGKILLed as soon as the
     first partial flush (batch 200) is on disk;
  3. resumed: relaunched; it must say "resuming dense inference at N"
     and finish.

It passes when the kill landed inside the run and the resumed imdb's
``wav_logits`` equal the clean run's bit for bit. RSS growth is reported,
not gated. On the card, from the repository root::

    python -m mcncrossmodalemotions_torch.tools.soak_dense_genesis [--frames 64000] [--work DIR]

``--tiny --batch-size 1`` rehearses it on the CPU with a tiny SENet; the
kill needs more than 200 batches to land inside a run.

The frames are 96x96 gray baseline JPEGs written without PIL (which the
card's host lacks) by ``data/images.py``'s writer: a few hundred seeded
base images are entropy coded once, and each frame is a base's scan under
its own quantisation table, so every file, and the pixels it decodes to,
is its own.
"""

from __future__ import annotations

import argparse
import json
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from mcncrossmodalemotions_torch.data import images

TRACKS = 32  # 8 speakers x 4 tracks
FRAME_SIZE = 96
VARIANTS = 64  # quantisation tables a base image is written with
RSS_EVERY_S = 2.0
POLL_S = 0.05  # how often the killed run's partial is looked for
MODULE = "mcncrossmodalemotions_torch.tools.soak_dense_genesis"


# -- the frames: gray baseline JPEGs (``data/images.py``'s writer) -------
_REF_Q = 16  # the quantiser the base coefficients are rounded with
# Huffman tables of fixed-length codes: the 12 DC categories in 4 bits, the
# 162 AC symbols (EOB, ZRL, run/size) in 8; no code is all ones.
_AC_SYMBOLS = bytes([0x00, 0xF0] + [(r << 4) | s for r in range(16)
                                    for s in range(1, 11)])
_HUFFMAN = ((0x00, bytes([0, 0, 0, 12] + [0] * 12), bytes(range(12))),
            (0x10, bytes([0] * 7 + [len(_AC_SYMBOLS)] + [0] * 8), _AC_SYMBOLS))
_CODES = [tuple(images.huffman_codes(bits, values)
                for _, bits, values in _HUFFMAN)]


def _jpeg(scan: bytes, size: int, q_dc: int, q_ac: int) -> bytes:
    """A gray ``size`` x ``size`` baseline JPEG of ``scan`` dequantised by
    a table of ``q_dc`` for DC and ``q_ac`` for every AC entry."""
    return images.jpeg_file(size, size, [(0x11, 0, 0x00)],
                            [np.asarray([q_dc] + [q_ac] * 63)], _HUFFMAN,
                            scan)


def _base_image(seed: int, size: int = FRAME_SIZE) -> np.ndarray:
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    period = rng.uniform(0.5, 3.0)
    base = 128 + 70 * np.sin(2 * np.pi * (xx * rng.uniform(0.5, 1.5) + yy)
                             / (period * size) + rng.uniform(0, 2 * np.pi))
    return np.clip(base + rng.randn(size, size) * 8, 0, 255).astype(np.uint8)


def track_frames(track: int, count: int, size: int = FRAME_SIZE) -> list:
    """The JPEG bytes of a track's ``count`` frames: base image
    ``f // VARIANTS`` of the track under table ``f % VARIANTS`` (DC and AC
    quantisers each 13..20)."""
    out = []
    for b in range(-(-count // VARIANTS)):
        zz = images.zigzag_coefficients(
            _base_image(track * 100003 + b, size), _REF_Q)
        scan = images.entropy_scan(zz, np.zeros(len(zz), np.int64), _CODES)
        for v in range(min(VARIANTS, count - b * VARIANTS)):
            out.append(_jpeg(scan, size, 13 + v % 8, 13 + v // 8))
    return out


# -- the soak ----------------------------------------------------------------
def generate_dataset(root: Path, num_frames: int, verbose: bool = True) -> int:
    """``<root>/wavs/<spk>/<track>.wav`` and ``<root>/frames/<spk>/<track>/
    *.jpg`` (fetch_emovoxceleb_imdb.m's layout), ``num_frames // 32`` unique
    96x96 JPEGs a track. Returns the frame count."""
    from mcncrossmodalemotions_torch.data.audio import write_wav

    per_track = num_frames // TRACKS
    t0 = time.monotonic()
    for ti in range(TRACKS):
        spk, trk = f"spk{ti % 8:02d}", f"trk{ti // 8:02d}"
        write_wav(root / "wavs" / spk / f"{trk}.wav",
                  np.zeros(1600, np.float32), 16000)
        fdir = root / "frames" / spk / trk
        fdir.mkdir(parents=True, exist_ok=True)
        for fi, data in enumerate(track_frames(ti, per_track)):
            (fdir / f"{fi:06d}.jpg").write_bytes(data)
    if verbose:
        print(f"generated {per_track * TRACKS} frames / {TRACKS} tracks in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
    return per_track * TRACKS


def _rss_mb() -> float:
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1024.0
    return 0.0


def soak_teacher(tiny: bool):
    """(pipeline, state): SENet50 at 224x224 (``tiny``: stage sizes (1, 1),
    width 8, at 48x48) from ``random_teacher_variables(seed=0)``,
    computing in bf16."""
    from mcncrossmodalemotions_torch.models.teacher_pipeline import (
        FaceTeacherPipeline,
    )
    from mcncrossmodalemotions_torch.zoo import (
        build_teacher,
        random_teacher_variables,
        teacher_state_dict_from_flax,
    )

    v = random_teacher_variables(
        seed=0, **(dict(stage_sizes=(1, 1), width=8) if tiny else {}))
    state = teacher_state_dict_from_flax(
        {"params": {"teacher": v["params"]},
         "batch_stats": {"teacher": v["batch_stats"]}})
    model = FaceTeacherPipeline(build_teacher("senet50-ferplus", tiny=tiny),
                                input_size=48 if tiny else 224,
                                augment=False).eval()
    return model, state


def worker(root: Path, out: Path, partial: Path, batch_size: int,
           tiny: bool) -> None:
    """One dense-genesis build in THIS process: on the card, or with
    ``tiny`` a tiny SENet on the CPU at two threads."""
    import torch
    from torch.func import functional_call

    from mcncrossmodalemotions_torch.exp.fetch_emovoxceleb_imdb import (
        build_imdb,
    )

    samples: list = []
    stop = threading.Event()
    t0 = time.monotonic()

    def sample_rss():
        while not stop.is_set():
            samples.append((round(time.monotonic() - t0, 2),
                            round(_rss_mb(), 1)))
            stop.wait(RSS_EVERY_S)

    sampler = threading.Thread(target=sample_rss, daemon=True)
    sampler.start()
    device = "cpu" if tiny else "cuda"
    if tiny:
        torch.set_num_threads(2)
    model, state = soak_teacher(tiny)
    warm = {k: v.to(device) for k, v in state.items()}
    with torch.inference_mode():  # cuDNN's set-up, outside the build
        functional_call(model, warm, (torch.zeros(
            (batch_size, 224, 224, 1), dtype=torch.uint8, device=device),)
        ).float().cpu()
    del warm
    init_s = time.monotonic() - t0

    t1 = time.monotonic()
    imdb = build_imdb(root, model, state, batch_size=batch_size,
                      partial_path=str(partial), verbose=True, device=device)
    build_s = time.monotonic() - t1
    stop.set()
    sampler.join()
    imdb.save(str(out))
    n = sum(len(f) for f in imdb.dense_frames)
    print(json.dumps({
        "kind": "soak-worker-result", "frames": n,
        "tracks": len(imdb.wav_logits), "build_sec": build_s,
        "imgs_per_sec": n / build_s, "init_sec": init_s,
        "batches": -(-n // batch_size), "rss_mb": samples}), flush=True)


def launch_worker(root: Path, out: Path, partial: Path, batch_size: int,
                  tiny: bool, log=subprocess.PIPE) -> subprocess.Popen:
    from mcncrossmodalemotions_torch.exp.dense_chunked import worker_env

    cmd = [sys.executable, "-m", MODULE, "--worker", "--root", str(root),
           "--out", str(out), "--partial", str(partial),
           "--batch-size", str(batch_size)] + (["--tiny"] if tiny else [])
    return subprocess.Popen(cmd, env=worker_env(), stdout=log,
                            stderr=subprocess.STDOUT, text=True)


def drain(proc: subprocess.Popen) -> list:
    """The worker's output lines, echoed as they come, to its end."""
    lines = []
    for line in proc.stdout:
        lines.append(line.rstrip("\n"))
        print(f"  | {line}", end="", flush=True)
    proc.wait()
    return lines


def _run(root, out, partial, batch_size, tiny, what: str) -> tuple:
    proc = launch_worker(root, out, partial, batch_size, tiny)
    lines = drain(proc)
    if proc.returncode != 0:
        raise RuntimeError(f"the {what} build failed (exit {proc.returncode})")
    res = json.loads([ln for ln in lines if '"soak-worker-result"' in ln][-1])
    return res, lines


def rss_summary(res: dict) -> dict:
    """The clean build's RSS: the first sample once the build is 25% done
    (the warm figure), the growth from it to the largest later sample,
    that growth per batch of the remaining 75%, the peak and the trace."""
    trace = res["rss_mb"]
    end = res["init_sec"] + res["build_sec"]
    warm_t = res["init_sec"] + 0.25 * res["build_sec"]
    after = [r for t, r in trace if warm_t < t <= end]
    growth = max(after) - after[0] if after else None
    return {"rss_warm_mb": after[0] if after else None,
            "rss_growth_after_warm_mb": growth,
            "rss_growth_per_batch_mb": (growth / (0.75 * res["batches"])
                                        if after else None),
            "rss_max_mb": max(r for _, r in trace),
            "rss_trace_mb": trace}


def card_line() -> str:
    """``name, power limit`` from nvidia-smi, or "not measured"."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "not measured"


def clean_build(root: Path, work: Path, batch_size: int, tiny: bool) -> dict:
    """Run 1: the uninterrupted build and its report (frames/s, RSS)."""
    print("[1/3] clean build ...", flush=True)
    res, _ = _run(root, work / "imdb_clean.npz", work / "clean.partial.npz",
                  batch_size, tiny, "clean")
    return {k: res[k] for k in ("frames", "tracks", "batches", "build_sec",
                                "imgs_per_sec", "init_sec")} | rss_summary(res)


def orchestrate(num_frames: int, work: Path, batch_size: int = 128,
                tiny: bool = False) -> dict:
    """The three runs and their report; raises when a run fails, the kill
    lands outside the run or the resume is not bitwise the clean build."""
    from mcncrossmodalemotions_torch.data.imdb import EmoVoxImdb

    work.mkdir(parents=True, exist_ok=True)
    root = work / "data"
    num_frames = num_frames // TRACKS * TRACKS
    if not (root / "frames").exists():
        generate_dataset(root, num_frames)
    report: dict = {"num_frames": num_frames, "tracks": TRACKS,
                    "batch_size": batch_size,
                    "device": "cpu (tiny SENet)" if tiny else card_line()}
    report["clean"] = clean_build(root, work, batch_size, tiny)

    print("[2/3] killed build (SIGKILL at the first partial flush) ...",
          flush=True)
    soak_out, partial = work / "imdb_soak.npz", work / "soak.partial.npz"
    partial.unlink(missing_ok=True)
    with open(work / "killed.log", "w") as log:
        proc = launch_worker(root, soak_out, partial, batch_size, tiny, log)
        deadline = time.monotonic() + 1800
        while (proc.poll() is None and not partial.exists()
               and time.monotonic() < deadline):
            time.sleep(POLL_S)
        proc.send_signal(signal.SIGKILL)  # the flush is a rename: whole
        proc.wait()
    if proc.returncode != -signal.SIGKILL:
        raise RuntimeError(f"the killed build ended by itself (exit "
                           f"{proc.returncode}) before the kill")
    if not partial.exists():
        raise RuntimeError("no partial checkpoint appeared within 30 min")
    with np.load(partial, allow_pickle=False) as data:
        killed_at = int(data["logits"].shape[0])
    report["killed_at_frames"] = killed_at
    if not 0 < killed_at < num_frames or soak_out.exists():
        raise RuntimeError(f"the kill landed outside the run ({killed_at}/"
                           f"{num_frames} frames)")
    print(f"  killed with {killed_at}/{num_frames} frames checkpointed",
          flush=True)

    print("[3/3] resumed build ...", flush=True)
    res, lines = _run(root, soak_out, partial, batch_size, tiny, "resumed")
    if not any("resuming dense inference at" in ln for ln in lines):
        raise RuntimeError("the resumed build did not pick up the partial")
    if partial.exists():
        raise RuntimeError("the finished build left its partial")
    report["resume"] = {"resumed_from": killed_at,
                        "build_sec": res["build_sec"],
                        "imgs_per_sec": (res["frames"] - killed_at)
                        / res["build_sec"]}  # the frames it scored

    a = EmoVoxImdb.load(str(work / "imdb_clean.npz"))
    b = EmoVoxImdb.load(str(soak_out))
    if not len(a.wav_logits) == len(b.wav_logits) == TRACKS or any(
            x.shape != y.shape for x, y in zip(a.wav_logits, b.wav_logits)):
        raise RuntimeError("the resumed imdb's tracks are not the clean one's")
    diff = max(float(np.abs(x - y).max())
               for x, y in zip(a.wav_logits, b.wav_logits))
    report["resume_vs_clean_max_abs_diff"] = diff
    if diff != 0.0:
        raise RuntimeError(f"resumed logits differ from the clean run "
                           f"(max {diff})")
    report["pass"] = True
    return report


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--root", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--partial", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--frames", type=int, default=64000)
    ap.add_argument("--work", type=Path,
                    default=Path(tempfile.gettempdir()) / "soak_dense_genesis")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--tiny", action="store_true",
                    help="a tiny SENet on the CPU (a rehearsal)")
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.root, args.out, args.partial, args.batch_size, args.tiny)
        return 0
    print(json.dumps(orchestrate(args.frames, args.work, args.batch_size,
                                 args.tiny)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
