"""What the program's recording (``mcncrossmodalemotions_torch/utils/
trace``) costs, on the card:

    python perfbench/recording_cost.py [--cell distill|dense] [--rounds 10]
        [--steps 20] [--batch 8] [--seed 1]

First one span (the whole ``with``), off and on: the best of 5 repeats of
20,000 spans, the record emptied before each; and one ``time.time_ns()``
read, of which a span makes two. Then, with recording off and
on in turns (``--rounds`` pairs, the first of each pair alternating):

- ``distill``: the distillation cell's step (``bench.train_step_setup``:
  int16 rows, pad mask, a batch that stays on the card) in blocks of
  ``--steps`` steps, each inside a ``train.step`` span as the engine
  makes: the host's time to issue a step and its wall once the card has
  drained. The cell is paced by the host; at the cell's batch of 64 this
  loop is paced by the card, whose queue of launches then absorbs the
  host's extra work. At ``--batch`` 8 (the default) the card runs a step
  well inside the host's issue of it, and the step's spans and hooks are
  the same in number, so the issue time carries their whole cost.
- ``dense``: the dense cell's set-up (its driver's, from ``--seed``) and
  one whole ``frame_logits`` pass over its frames a turn: the frames a
  second of the card's forward time (CUDA events around each forward, the
  cell's own rate) and of wall.

One JSON line each; the last has the medians, the cost (%, positive where
recording on is slower) and how many pairs read slower with recording on.
The benchmark's own runs never run this.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
import timeit  # noqa: E402


def one_span_ns(trace, n: int = 20_000) -> dict:
    """ns a call of the whole ``with trace.span(...)``, off and on (the best
    of 5 repeats of ``n``, the record emptied before each)."""

    def with_span():
        with trace.span("train.step", step=3):
            pass

    out = {}
    for mode in ("off", "on"):
        best = float("inf")
        for _ in range(5):
            trace.reset()
            (trace.enable if mode == "on" else trace.disable)()
            best = min(best, timeit.timeit(with_span, number=n) / n * 1e9)
            trace.disable()
        trace.reset()
        out[f"span_{mode}_ns"] = best
    out["clock_read_ns"] = min(timeit.repeat(time.time_ns, number=n, repeat=5)) / n * 1e9
    return out


def _turns(rounds: int, measure, trace) -> dict:
    """``measure()`` (a dict of readings) with recording off and on in
    turns; the readings by mode."""
    got = {"off": [], "on": []}
    for rnd in range(rounds):
        for mode in (("off", "on") if rnd % 2 == 0 else ("on", "off")):
            if mode == "on":
                trace.enable()
            try:
                got[mode].append(measure())
            finally:
                trace.disable()
                trace.reset()
        print(json.dumps({"round": rnd, "off": got["off"][-1], "on": got["on"][-1]}),
              flush=True)
    return got


def _summary(got: dict, keys, slower_if_higher: dict) -> dict:
    out = {}
    for key in keys:
        off = [r[key] for r in got["off"]]
        on = [r[key] for r in got["on"]]
        med_off, med_on = statistics.median(off), statistics.median(on)
        sign = 1 if slower_if_higher[key] else -1
        out[key] = {"off": off, "on": on, "median_off": med_off, "median_on": med_on,
                    "cost_pct": sign * 100 * (med_on / med_off - 1),
                    "pairs_on_slower": sum(sign * (a - b) > 0 for a, b in zip(on, off))}
    return out


def distill_turns(args, device, tiny: bool, trace) -> dict:
    import torch

    from mcncrossmodalemotions_torch.bench import train_step_setup

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    step, state, batch = train_step_setup(
        device, batch_size=2 if tiny else args.batch, num_frames=100 if tiny else 400, tiny=tiny,
        int16_rows=True, pad_mask=True)
    for _ in range(2 if tiny else 5):
        state, _ = step(state, batch, 1e-4)
    sync()

    def measure():
        nonlocal state
        t0 = time.perf_counter()
        for k in range(args.steps):
            with trace.span("train.step", step=k):
                state, _ = step(state, batch, 1e-4)
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        return {"issue_ms": (t1 - t0) / args.steps * 1e3,
                "step_ms": (t2 - t0) / args.steps * 1e3}

    got = _turns(args.rounds, measure, trace)
    return _summary(got, ("issue_ms", "step_ms"), {"issue_ms": True, "step_ms": True})


def dense_turns(args, device, tiny: bool, trace) -> dict:
    from perfbench.drivers import dense
    from perfbench.drivers.common import DeviceTimer
    from perfbench.harness import cli, spec

    cell = spec.load_cell("dense-senet50-jpeg-b128", rehearse=tiny)
    with tempfile.TemporaryDirectory(prefix="perfbench_") as tmp:
        run = cli.Run(cell=cell, seed=args.seed, seconds=0.0, trace=False, device=device,
                      rehearse=tiny, tmp=Path(tmp))
        ctx = dense.setup(run)
        paths, extractor = ctx["frames"].paths, ctx["extractor"]

        def measure():
            with DeviceTimer(ctx["pipeline"], device) as forwards:
                t0 = time.perf_counter()
                out = extractor.frame_logits(paths, verbose=False)
                run.sync()
                wall = time.perf_counter() - t0
            assert len(out) == len(paths)
            return {"device_frames_per_s": len(paths) / forwards.seconds(),
                    "wall_frames_per_s": len(paths) / wall}

        got = _turns(args.rounds, measure, trace)
    return _summary(got, ("device_frames_per_s", "wall_frames_per_s"),
                    {"device_frames_per_s": False, "wall_frames_per_s": False})


def main(argv=None, device: str = "cuda", tiny: bool = False) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=("distill", "dense"), default="distill")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from mcncrossmodalemotions_torch.utils import trace

    print(json.dumps({"micro": one_span_ns(trace, 2_000 if tiny else 20_000)}), flush=True)
    turns = distill_turns if args.cell == "distill" else dense_turns
    res = dict(turns(args, torch.device(device), tiny, trace), cell=args.cell,
               batch=args.batch if args.cell == "distill" else None,
               device=torch.cuda.get_device_name() if device == "cuda" else "cpu")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
