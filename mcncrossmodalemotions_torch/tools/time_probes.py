"""The probe kernels' times on the card, optionally against another checkout.

    python -m mcncrossmodalemotions_torch.tools.time_probes [--iters 200]
        [--against DIR] [--device cpu]

Each of the 17 probes of ``probe_mosaic`` and ``probe_mosaic2`` is timed
as ``chip_smoke.py`` times it: ``bench.cuda_ms`` (CUDA events around
``iters`` calls queued behind a device sleep), kernel and plain version in
turns (plain, kernel, kernel, plain), and the library call
(``index_select`` for the gathers, ``torch.matmul`` for P9) after them.
The launch floor is a one-element ``probe_gather`` timed the same way.
Beside each time: the path the kernel took (``ops/probes.Route``, where the
package records one), the bytes bound (each input element the probe reads
once, each output written once, at 3.35 TB/s) and the floor share,
max(bound, floor) / time.

With ``--against DIR`` (another checkout of the repository, such as the
parent commit's ``git archive`` unpacked under ``build/``) four worker
processes run in turns on the one card: DIR's package, this one's, this
one's, DIR's. Each imports its tree's package through ``PYTHONPATH`` and
times it with this file's code; the two runs of a tree are averaged.
``--device cpu`` rehearses the flow on the CPU (the plain versions on both
sides; no device time). The last line is one JSON object of the records.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

PROBE_ITERS = 200             # probe kernels take microseconds
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
THIS_TREE = Path(__file__).resolve().parents[2]


def probe_work(probe) -> tuple:
    """(bytes, operations) a probe's kernel needs: each input element it
    reads once (a gather only the rows its index map names), each output
    element written once."""
    import numpy as np

    from mcncrossmodalemotions_torch.ops import probes

    if probe.kernel is probes.probe_gather:
        x, index, axis = probe.args
        n_out = index.values.numel()
        rows = x.numel() // x.shape[axis]
        used = len(np.unique(index.values.cpu().numpy()))
        return (used * rows * x.element_size() + 4 * n_out
                + 4 * rows * n_out, 0)
    if probe.kernel is probes.probe_select_matmul:
        (m, k), n = probe.args[0].shape, probe.args[1].shape[1]
        return 4 * (m * k + k * n + m * n), 2 * m * k * n
    # probe_col_candidates: 2 compares, 1 and and 2 adds per output
    x, y, dy = probe.args
    return 4 * (2 * x.numel() + y.numel() + dy.numel()), 5 * x.numel()


def bound_ms(nbytes: float, ops: float) -> float:
    """The least milliseconds an H100 takes to move ``nbytes`` through
    device memory and do ``ops`` fp32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def measure(device="cuda", iters: int = PROBE_ITERS) -> dict:
    """This process's package's probes timed on ``device``: {"package",
    "floor_ms", "probes": [{"name", "kernel", "path", "kernel_ms",
    "plain_ms", "library_ms", "bound_ms"}, ...]}."""
    import torch

    import mcncrossmodalemotions_torch as port
    from mcncrossmodalemotions_torch.bench import device_ms
    from mcncrossmodalemotions_torch.ops import probes
    from mcncrossmodalemotions_torch.tools import probe_mosaic, probe_mosaic2
    from mcncrossmodalemotions_torch.utils.device import resolve_device

    dev = resolve_device(device, "time_probes")

    def turns(*fns):
        first = [device_ms(f, dev, iters) for f in fns]
        second = [device_ms(f, dev, iters) for f in reversed(fns)][::-1]
        return [(a + b) / 2 for a, b in zip(first, second)]

    one = torch.zeros(1, device=dev)
    one_index = probes.index_map([0], 1, dev)
    floor = device_ms(lambda: probes.probe_gather(one, one_index, 0), dev,
                      iters)
    library = {probes.probe_gather: lambda x, index, axis: torch.index_select(
                   x, axis, index.values),
               probes.probe_select_matmul: torch.matmul}
    rows = []
    for p in probe_mosaic.make_probes(dev) + probe_mosaic2.make_probes(dev):
        plain_ms, kernel_ms = turns(lambda: p.run(plain=True), lambda: p.run())
        route = getattr(p.kernel, "route", None)
        lib = library.get(p.kernel)
        rows.append({
            "name": p.name, "kernel": p.kernel.__name__,
            "path": None if route is None else list(route),
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None if lib is None else device_ms(
                lambda: lib(*p.args), dev, iters),
            "bound_ms": bound_ms(*probe_work(p))})
    return {"package": str(Path(port.__file__).resolve().parent),
            "floor_ms": floor, "probes": rows}


def _worker(tree: Path, device: str, iters: int) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tree)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    run = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         "--device", device, "--iters", str(iters)],
        env=env, capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise RuntimeError(f"time_probes worker over {tree} failed:\n"
                           f"{run.stderr[-3000:]}")
    record = json.loads(run.stdout.strip().splitlines()[-1])
    want = (tree / "mcncrossmodalemotions_torch").resolve()
    if Path(record["package"]) != want:
        raise RuntimeError(f"the worker over {tree} imported "
                           f"{record['package']}, not {want}")
    return record


def _mean(a: dict, b: dict) -> dict:
    """The mean of two runs' times of one tree."""
    out = dict(a, floor_ms=(a["floor_ms"] + b["floor_ms"]) / 2, probes=[])
    for p, q in zip(a["probes"], b["probes"]):
        out["probes"].append(dict(p, **{
            k: None if p[k] is None else (p[k] + q[k]) / 2
            for k in ("kernel_ms", "plain_ms", "library_ms")}))
    return out


def main(device="cuda", iters: int = PROBE_ITERS, against=None) -> dict:
    """{"this": record[, "against": record]}; prints a line a probe and the
    sums by kernel, and the records last."""
    if against is None:
        records = {"this": measure(device, iters)}
    else:
        order = [("against", Path(against).resolve()), ("this", THIS_TREE)]
        runs = {"against": [], "this": []}
        for side, tree in order + order[::-1]:
            runs[side].append(_worker(tree, device, iters))
        records = {side: _mean(*r) for side, r in runs.items()}
    this = records["this"]
    other = records.get("against")
    floor = this["floor_ms"]
    print(f"launch floor {floor:.5f} ms" + (
        "" if other is None else f" (against: {other['floor_ms']:.5f} ms)"))
    sums: dict = {}
    for k, p in enumerate(this["probes"]):
        ms = p["kernel_ms"]
        share = max(p["bound_ms"], floor) / ms
        was = "" if other is None else (
            f", against {other['probes'][k]['kernel_ms']:.5f} ms")
        lib = ("" if p["library_ms"] is None
               else f", library {p['library_ms']:.5f} ms")
        print(f"{p['name']} ({p['kernel']}, path {p['path']}): kernel "
              f"{ms:.5f} ms{was}, plain {p['plain_ms']:.5f} ms{lib}; bound "
              f"{p['bound_ms']:.5f} ms (bytes), {share:.1%} of max(bound, "
              f"floor)")
        s = sums.setdefault(p["kernel"], [0.0, 0.0, 0.0, 0])
        s[0] += ms
        s[1] += 0.0 if other is None else other["probes"][k]["kernel_ms"]
        s[2] += p["bound_ms"]
        s[3] += 1
    for name, (ms, was, bound, n) in sums.items():
        least = max(bound, n * floor)
        print(f"{name}: {n} launch(es), kernel {ms:.5f} ms"
              + ("" if other is None else f" (against {was:.5f} ms)")
              + f", bound {bound:.5f} ms, launch floor {n * floor:.5f} ms, "
              f"{least / ms:.1%} of max(bound, floor)")
    print(json.dumps(records))
    return records


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=PROBE_ITERS)
    ap.add_argument("--against", default=None,
                    help="another checkout of the repository, timed in turns")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(measure(args.device, args.iters)))
    else:
        main(args.device, args.iters, args.against)
