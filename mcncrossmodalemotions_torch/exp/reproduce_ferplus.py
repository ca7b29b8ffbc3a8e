"""FER2013+ benchmark reproduction (the reference's regression), PyTorch.

Port of ``mcncrossmodalemotions_tpu/exp/reproduce_ferplus.py``. The
reference's de-facto regression test is rerunning
``benchmark_ferplus_models`` against its README accuracy table
(README.md:40-41):

    resnet50-ferplus   val 89.0 %   test 87.6 %
    senet50-ferplus    val 89.8 %   test 88.8 %

    python -m mcncrossmodalemotions_torch.exp.reproduce_ferplus \\
        --fer-csv fer2013.csv --ferplus-csv fer2013new.csv

resolves the released teacher ``.mat`` weights through the artifact
registry (download on a miss; ``--no-download`` for offline use, or
``--resnet50-mat``/``--senet50-mat`` for files elsewhere), parses the csvs
into the imdb (``data/ferplus.parse_ferplus_csvs``), evaluates both
released teachers on val and test on the card through the preprocessing
chain (gray -> 3 channels, mean subtraction, bilinear resize), compares
with the table within ``tolerance`` and writes ``report.json``. The csvs
are under a Kaggle licence and cannot be redistributed or downloaded
(``CSV_SOURCES`` says where they come from).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import torch

# README.md:40-41 of the reference
EXPECTED_ACCURACY: Dict[str, Dict[str, float]] = {
    "resnet50-ferplus": {"valAcc": 0.890, "testAcc": 0.876},
    "senet50-ferplus": {"valAcc": 0.898, "testAcc": 0.888},
}
# half a percentage point: the JAX package's acceptance band (bf16 conv
# stacks and resize kernels across the import, and run variance)
DEFAULT_TOLERANCE = 0.005

MODELS = (("resnet50-ferplus", "softmaxlog"),
          ("senet50-ferplus", "distributions"))

CSV_SOURCES = {
    "fer_csv": "fer2013.csv: the Kaggle 'Challenges in Representation "
               "Learning: Facial Expression Recognition Challenge' data "
               "(its licence forbids redistribution)",
    "ferplus_csv": "fer2013new.csv: the FER+ rater votes, from Microsoft's "
                   "FERPlus repository (github.com/microsoft/FERPlus)",
}


def check_results(results: Dict[str, Dict[str, float]],
                  tolerance: float = DEFAULT_TOLERANCE,
                  expected: Optional[dict] = None) -> dict:
    """Compare measured accuracies with the reference table: ``{"pass",
    "tolerance", "rows"}``, one row a (model, subset); a missing model or
    subset fails."""
    expected = expected or EXPECTED_ACCURACY
    rows, ok = [], True
    for model, want in expected.items():
        got = results.get(model)
        for subset, target in want.items():
            measured = None if got is None else got.get(subset)
            passed = (measured is not None
                      and abs(measured - target) <= tolerance)
            ok &= passed
            rows.append({"model": model, "subset": subset,
                         "expected": target, "measured": measured,
                         "pass": passed})
    return {"pass": ok, "tolerance": tolerance, "rows": rows}


def reproduce_ferplus(fer_csv: str, ferplus_csv: str,
                      mats: Optional[Dict[str, str]] = None,
                      out_root: str = "exps/reproduce-ferplus",
                      tolerance: float = DEFAULT_TOLERANCE,
                      download: bool = True,
                      batch_size: int = 128, input_size: int = 224,
                      device: torch.device | str = "cuda") -> dict:
    """Run the reproduction; returns the ``check_results`` report.
    ``mats`` maps a name of ``MODELS`` to its released ``.mat`` path; a
    name it leaves out resolves through the artifact registry
    (``fetch_artifact(name, download=download)``). A missing csv raises
    ``FileNotFoundError`` after printing where it comes from."""
    from mcncrossmodalemotions_torch.data.ferplus import parse_ferplus_csvs
    from mcncrossmodalemotions_torch.exp.ferplus_baselines import (
        FerPlusConfig,
        benchmark_ferplus_models,
    )

    for key, path in (("fer_csv", fer_csv), ("ferplus_csv", ferplus_csv)):
        if not Path(path).is_file():
            print(f"missing {path}; it is {CSV_SOURCES[key]}", flush=True)
            raise FileNotFoundError(path)
    from mcncrossmodalemotions_torch.zoo.artifacts import fetch_artifact

    mats = {name: str((mats or {}).get(name)
                      or fetch_artifact(name, download=download))
            for name, _ in MODELS}
    imdb = parse_ferplus_csvs(fer_csv, ferplus_csv)
    results = benchmark_ferplus_models(
        imdb, out_root=out_root, models=MODELS, pretrained_mats=mats,
        base_cfg=FerPlusConfig(batch_size=batch_size, input_size=input_size),
        cache_dir=str(Path(out_root) / "cache"), device=device)
    report = check_results(results, tolerance)
    report["results"] = results
    out = Path(out_root)
    out.mkdir(parents=True, exist_ok=True)
    (out / "report.json").write_text(json.dumps(report, indent=2) + "\n")
    for row in report["rows"]:
        status = "PASS" if row["pass"] else "FAIL"
        measured = ("none" if row["measured"] is None
                    else f"{row['measured']:.3f}")
        print(f"[{status}] {row['model']} {row['subset']}: "
              f"measured {measured} vs expected {row['expected']:.3f} "
              f"(±{tolerance})")
    return report


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fer-csv", required=True, help=CSV_SOURCES["fer_csv"])
    p.add_argument("--ferplus-csv", required=True,
                   help=CSV_SOURCES["ferplus_csv"])
    p.add_argument("--out-root", default="exps/reproduce-ferplus")
    p.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--input-size", type=int, default=224)
    p.add_argument("--no-download", action="store_true")
    p.add_argument("--resnet50-mat", default=None,
                   help="a resnet50-ferplus .mat outside the registry's cache")
    p.add_argument("--senet50-mat", default=None,
                   help="a senet50-ferplus .mat outside the registry's cache")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    mats = {name: path for name, path in (
        ("resnet50-ferplus", args.resnet50_mat),
        ("senet50-ferplus", args.senet50_mat)) if path}
    report = reproduce_ferplus(
        args.fer_csv, args.ferplus_csv, mats,
        out_root=args.out_root, tolerance=args.tolerance,
        download=not args.no_download,
        batch_size=args.batch_size, input_size=args.input_size,
        device=args.device)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
