"""One-command release-verification gate (``cli verify-release``).

Port of ``mcncrossmodalemotions_tpu/exp/verify_release.py``, on one device
(the card unless the caller passes ``device="cpu"``). The reference's
release is "verified" by hand: download the released models
(emoVoxZoo.m:74-102 / ferPlusZoo.m fetchModel prompts) and the prebuilt
logits imdb (fetch_emovoxceleb_imdb.m:288-324), re-run the FER+ benchmark
and compare it by eye with the README accuracy table (README.md:38-47).
This module runs that battery as one command and writes a pass/fail
report:

1. ``artifacts``: resolve and pin every requested released artifact through
   the registry (``zoo/artifacts.py``: download on a miss, sha256
   sidecars, re-hashed in full here); with a ``sha_manifest`` JSON of
   provenance pins, the bytes must also match that record.
2. ``import_forward``: import each released model ``.mat`` (classic or
   -v7.3), run a deterministic probe forward on ``device`` (the student
   through its frontend: on the card one K1 and two K2 launches) and gate
   on finite, non-degenerate logits of the right arity.
3. ``container_agreement``: where a ``<name>-v73.mat`` sibling lies next to
   a release file, the classic and HDF5 importer paths must give
   bitwise-identical parameter trees.
4. ``released_logits``: import the prebuilt EmoVoxCeleb logits imdb and
   gate on its structure (track/logit alignment, 8 emotion columns,
   finite values, sane magnitudes).
5. ``ferplus_accuracy``: given the FER2013/FER+ csvs (Kaggle-licensed,
   user-supplied), evaluate the released teachers on val and test and gate
   against the README table within tolerance (``exp/reproduce_ferplus.py``).

A stage that lacks its inputs (offline, no csvs) skips and says why. The
release passes only when a stage executed, none failed, and every
requested artifact was present (``unverified`` lists a miss).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mcncrossmodalemotions_torch.exp.reproduce_ferplus import (
    DEFAULT_TOLERANCE,
    EXPECTED_ACCURACY,
    MODELS,
    check_results,
)
from mcncrossmodalemotions_torch.utils.device import resolve_device

# registry names of the released models the README documents
RELEASE_MODELS = ("emovoxceleb-student", "resnet50-ferplus",
                  "senet50-ferplus")
NUM_EMOTIONS = 8
# released teacher logits on real frames live well inside +/-60; a
# mis-transposed or mis-scaled import blows far past this
LOGIT_MAGNITUDE_CAP = 1e3


def _stage(status: str, **detail) -> dict:
    return {"status": status, **detail}


def _probe_logit_gate(logits: np.ndarray, what: str) -> Optional[str]:
    """A failure reason for degenerate probe logits, else None: NaN/Inf
    from garbage kernels, constant outputs from zeroed or broadcast
    parameters, magnitude blow-ups from mis-transposed matrices."""
    if logits.ndim != 2 or logits.shape[1] != NUM_EMOTIONS:
        return (f"{what}: probe logits shaped {logits.shape}, expected "
                f"[B, {NUM_EMOTIONS}]")
    if not np.all(np.isfinite(logits)):
        return f"{what}: probe logits contain NaN/Inf"
    if float(np.std(logits)) == 0.0:
        return f"{what}: probe logits are constant (degenerate import)"
    if float(np.max(np.abs(logits))) > LOGIT_MAGNITUDE_CAP:
        return (f"{what}: probe logit magnitude "
                f"{float(np.max(np.abs(logits))):.3g} exceeds "
                f"{LOGIT_MAGNITUDE_CAP:g} (mis-scaled import?)")
    return None


def probe_logits(name: str, path, rng: np.random.RandomState, *,
                 probe_image_size: int, probe_wav_seconds: float,
                 device: torch.device | str) -> np.ndarray:
    """The ``import_forward`` probe of one release: its ``.mat`` loaded on
    ``device`` and run on inputs drawn from ``rng`` in the JAX package's
    order, the student on two waveforms of ``probe_wav_seconds`` (x 0.1)
    through its frontend, a teacher on two ``probe_image_size`` RGB images
    (x 20). Returns the [2, 8] logits in float64."""
    from mcncrossmodalemotions_torch import zoo
    from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC

    if name == "emovoxceleb-student":
        model, _ = zoo.load_pretrained_student(str(path), with_frontend=True,
                                               device=device)
        n_frames = max(int(probe_wav_seconds * 100), 8)
        x = rng.randn(2, DEFAULT_SPEC.crop_samples(n_frames)).astype(
            np.float32) * 0.1
    else:
        model, _ = zoo.load_pretrained_teacher(str(path), device=device)
        x = rng.randn(2, probe_image_size, probe_image_size, 3).astype(
            np.float32) * 20.0
    with torch.inference_mode():
        logits = model(torch.from_numpy(x).to(device))
    return logits.float().cpu().numpy().astype(np.float64)


def _verify_artifacts(names: Sequence[str], root, download: bool,
                      manifest: Optional[Dict[str, str]] = None) -> tuple:
    from mcncrossmodalemotions_torch.zoo.artifacts import (
        ArtifactCorrupt,
        ArtifactUnavailable,
        _file_sha256,
        fetch_artifact,
    )

    manifest = manifest or {}
    rows, paths = [], {}
    for name in names:
        try:
            # full_check: re-hash against the pinned sidecar even when the
            # size matches; this gate exists to catch corruption
            p = fetch_artifact(name, root=root, download=download,
                               full_check=True)
            sidecar = p.with_suffix(p.suffix + ".sha256")
            pinned = (sidecar.read_text().split()[0]
                      if sidecar.exists() else None)
            expected = manifest.get(name)
            if expected and not pinned:
                # a manifest pin never goes unchecked: without a sidecar
                # (a torn write counts as no pin), hash the bytes here
                pinned = _file_sha256(p)
            if expected and expected.lower() != pinned.lower():
                # the bytes match their own sidecar but not the provenance
                # pin: the wrong release, a hard failure
                rows.append({
                    "name": name, "status": "corrupt", "path": str(p),
                    "error": (f"sha256 {pinned} does not match the "
                              f"manifest pin {expected} — wrong or "
                              "tampered release file")})
                continue
            rows.append({"name": name, "status": "ok", "path": str(p),
                         "sha256": pinned,
                         "manifest": ("match" if expected else None)})
            paths[name] = p
        except ArtifactCorrupt as exc:
            # bytes on disk fail their sha256 pin: a release-integrity
            # failure, never a benign miss
            rows.append({"name": name, "status": "corrupt",
                         "error": str(exc)})
        except ArtifactUnavailable as exc:
            rows.append({"name": name, "status": "missing",
                         "error": str(exc)})
        except Exception as exc:  # registry/key errors are hard failures
            rows.append({"name": name, "status": "error",
                         "error": f"{type(exc).__name__}: {exc}"})
    n_ok = sum(r["status"] == "ok" for r in rows)
    missing = [r["name"] for r in rows if r["status"] == "missing"]
    if any(r["status"] in ("error", "corrupt") for r in rows):
        status = "fail"
    elif n_ok == 0:
        status = "skip"
    else:
        status = "pass"
    return _stage(status, rows=rows, available=n_ok, requested=len(names),
                  missing=missing), paths


def _verify_import_forward(paths: Dict[str, Path], *,
                           probe_image_size: int, probe_wav_seconds: float,
                           device: torch.device) -> dict:
    rows = []
    rng = np.random.RandomState(0)  # deterministic probes
    for name, path in paths.items():
        row = {"name": name, "path": str(path)}
        try:
            logits = probe_logits(name, path, rng,
                                  probe_image_size=probe_image_size,
                                  probe_wav_seconds=probe_wav_seconds,
                                  device=device)
            reason = _probe_logit_gate(logits, name)
            row["logit_std"] = float(np.std(logits))
            row["logit_absmax"] = float(np.max(np.abs(logits)))
            if reason is None:
                row["status"] = "pass"
            else:
                row.update(status="fail", error=reason)
        except Exception as exc:
            row.update(status="fail",
                       error=f"{type(exc).__name__}: {exc}")
        rows.append(row)
    if not rows:
        return _stage("skip", reason="no model artifacts available",
                      rows=[])
    ok = all(r["status"] == "pass" for r in rows)
    return _stage("pass" if ok else "fail", rows=rows)


def _verify_container_agreement(paths: Dict[str, Path]) -> dict:
    """Where both containers of a release are on disk, the registry file
    and a ``<stem>-v73.mat`` sibling (MATLAB's -v7.3/HDF5 re-save of the
    same net), the two importer paths (scipy classic and h5py,
    ``zoo/matconvnet.load_mat_params``) must give the same names, dtypes
    and values: the coarse probe above passes a subtly wrong import
    (permuted channels). A release without a sibling is no row; without
    any, the stage skips."""
    from mcncrossmodalemotions_torch.zoo.matconvnet import load_mat_params

    rows = []
    for name, path in paths.items():
        alt = path.with_name(path.stem + "-v73" + path.suffix)
        if not alt.exists():
            continue
        row = {"name": name, "classic": str(path), "v73": str(alt)}
        try:
            a = load_mat_params(path)
            b = load_mat_params(alt)
            problems = []
            for k in sorted(set(a) | set(b)):
                if k not in a or k not in b:
                    problems.append(f"param {k!r} only in "
                                    f"{'v73' if k in b else 'classic'}")
                    continue
                x, y = np.squeeze(a[k]), np.squeeze(b[k])
                if x.dtype != y.dtype:
                    problems.append(
                        f"param {k!r}: dtype {x.dtype} vs {y.dtype}")
                elif x.shape != y.shape:
                    problems.append(
                        f"param {k!r}: shape {x.shape} vs {y.shape}")
                elif not np.array_equal(x, y):
                    diff = np.max(np.abs(x.astype(np.float64)
                                         - y.astype(np.float64)))
                    problems.append(f"param {k!r}: values differ (max abs "
                                    f"diff {float(diff):.3g})")
            if problems:
                row.update(status="fail", problems=problems)
            else:
                row.update(status="pass", params=len(a))
        except Exception as exc:
            row.update(status="fail",
                       error=f"{type(exc).__name__}: {exc}")
        rows.append(row)
    if not rows:
        return _stage("skip", reason="no classic/v7.3 container pair on "
                      "disk (place a <name>-v73.mat next to the release "
                      "file to enable)", rows=[])
    ok = all(r["status"] == "pass" for r in rows)
    return _stage("pass" if ok else "fail", rows=rows)


def _verify_released_logits(mat_path: Optional[Path]) -> dict:
    if mat_path is None:
        return _stage("skip",
                      reason="emovoxceleb-logits artifact unavailable")
    try:
        from mcncrossmodalemotions_torch.data.imdb import emovox_imdb_from_mat

        imdb = emovox_imdb_from_mat(mat_path, with_frames=False)
        n = len(imdb.wav_paths)
        problems = []
        if n == 0:
            problems.append("imdb has zero tracks")
        if len(imdb.wav_logits) != n:
            problems.append(
                f"wav_logits count {len(imdb.wav_logits)} != tracks {n}")
        absmax = 0.0
        for i, l in enumerate(imdb.wav_logits):
            arr = np.asarray(l)
            if arr.ndim != 2 or arr.shape[1] != NUM_EMOTIONS:
                problems.append(
                    f"track {i}: logits shaped {arr.shape}, expected "
                    f"[F, {NUM_EMOTIONS}]")
                break
            if arr.shape[0] == 0:
                problems.append(f"track {i}: zero logit rows")
                break
            if not np.all(np.isfinite(arr)):
                problems.append(f"track {i}: NaN/Inf logits")
                break
            absmax = max(absmax, float(np.max(np.abs(arr))))
        if absmax > LOGIT_MAGNITUDE_CAP:
            problems.append(
                f"logit magnitude {absmax:.3g} exceeds "
                f"{LOGIT_MAGNITUDE_CAP:g}")
        if problems:
            return _stage("fail", problems=problems, tracks=n)
        return _stage("pass", tracks=n, logit_absmax=absmax)
    except Exception as exc:
        return _stage("fail", problems=[f"{type(exc).__name__}: {exc}"])


def _verify_ferplus(fer_csv: Optional[str], ferplus_csv: Optional[str],
                    paths: Dict[str, Path], *, out_root: Path,
                    tolerance: float, expected: Optional[dict],
                    batch_size: int, input_size: int,
                    device: torch.device) -> dict:
    if not fer_csv or not ferplus_csv:
        return _stage("skip", reason="FER2013/FER+ csvs not supplied "
                      "(Kaggle-licensed; pass fer_csv=/ferplus_csv=)")
    expected = expected or EXPECTED_ACCURACY
    # gate every expected model whose artifact is available; skip only
    # when none is, so models=resnet50-ferplus still gates that model
    candidates = tuple((name, loss) for name, loss in MODELS
                       if name in expected)
    models = tuple((name, loss) for name, loss in candidates
                   if name in paths)
    missing = [name for name, _ in candidates if name not in paths]
    if not models:
        return _stage("skip",
                      reason=f"model artifacts unavailable: {missing}")
    expected = {name: expected[name] for name, _ in models}
    try:
        from mcncrossmodalemotions_torch.data.ferplus import (
            parse_ferplus_csvs,
        )
        from mcncrossmodalemotions_torch.exp.ferplus_baselines import (
            FerPlusConfig,
            benchmark_ferplus_models,
        )

        imdb = parse_ferplus_csvs(fer_csv, ferplus_csv)
        results = benchmark_ferplus_models(
            imdb, out_root=str(out_root / "ferplus"), models=models,
            pretrained_mats={n: str(paths[n]) for n, _ in models},
            base_cfg=FerPlusConfig(batch_size=batch_size,
                                   input_size=input_size),
            cache_dir=str(out_root / "ferplus" / "cache"), device=device)
        report = check_results(results, tolerance, expected=expected)
        return _stage("pass" if report["pass"] else "fail",
                      tolerance=tolerance, rows=report["rows"],
                      results=results, skipped_models=missing)
    except Exception as exc:
        return _stage("fail",
                      problems=[f"{type(exc).__name__}: {exc}"])


def verify_release(*,
                   models: Sequence[str] = RELEASE_MODELS,
                   artifact_root: Optional[str] = None,
                   download: bool = True,
                   check_logits_imdb: bool = True,
                   fer_csv: Optional[str] = None,
                   ferplus_csv: Optional[str] = None,
                   tolerance: float = DEFAULT_TOLERANCE,
                   expected_accuracy: Optional[dict] = None,
                   probe_image_size: int = 224,
                   probe_wav_seconds: float = 4.0,
                   ferplus_batch_size: int = 128,
                   ferplus_input_size: int = 224,
                   sha_manifest: Optional[str] = None,
                   out_root: str = "exps/verify-release",
                   verbose: bool = True,
                   device: torch.device | str = "cuda") -> dict:
    """Run the release-verification battery on ``device``; return the
    report and write it to ``<out_root>/verify-release.json``.

    ``expected_accuracy`` overrides the README table; ``artifact_root``
    points the registry at a local artifact tree (releases placed by hand)
    instead of the default cache; ``sha_manifest`` names a JSON file of
    ``{artifact_name: sha256}`` provenance pins. A ``<name>-v73.mat``
    sibling next to a release file enables the container agreement stage.
    Without a CUDA device the default ``device`` raises.
    """
    device = resolve_device(device, "verify_release")
    out = Path(out_root)
    out.mkdir(parents=True, exist_ok=True)

    manifest = None
    if sha_manifest:
        manifest = {str(k): str(v)
                    for k, v in json.loads(
                        Path(sha_manifest).read_text()).items()}
    artifact_names = list(models)
    if check_logits_imdb:
        artifact_names.append("emovoxceleb-logits")
    stage_artifacts, paths = _verify_artifacts(
        artifact_names, artifact_root, download, manifest=manifest)
    model_paths = {n: p for n, p in paths.items() if n in models}
    stage_import = _verify_import_forward(
        model_paths, probe_image_size=probe_image_size,
        probe_wav_seconds=probe_wav_seconds, device=device)
    stage_containers = _verify_container_agreement(model_paths)
    stage_logits = (_verify_released_logits(paths.get("emovoxceleb-logits"))
                    if check_logits_imdb
                    else _stage("skip", reason="disabled"))
    stage_ferplus = _verify_ferplus(
        fer_csv, ferplus_csv, paths, out_root=out, tolerance=tolerance,
        expected=expected_accuracy, batch_size=ferplus_batch_size,
        input_size=ferplus_input_size, device=device)

    stages = {"artifacts": stage_artifacts,
              "import_forward": stage_import,
              "container_agreement": stage_containers,
              "released_logits": stage_logits,
              "ferplus_accuracy": stage_ferplus}
    executed = [k for k, s in stages.items() if s["status"] != "skip"]
    failed = [k for k, s in stages.items() if s["status"] == "fail"]
    # no PASS over artifacts the gate never saw: a requested artifact that
    # is missing leaves the release unverified
    unverified = stage_artifacts.get("missing", [])
    report = {
        "pass": bool(executed) and not failed and not unverified,
        "executed": executed,
        "failed": failed,
        "unverified": unverified,
        "skipped": [k for k in stages if k not in executed],
        "stages": stages,
    }
    (out / "verify-release.json").write_text(
        json.dumps(report, indent=2, default=str) + "\n")
    if verbose:
        for name, s in stages.items():
            print(f"[{s['status'].upper():4s}] {name}"
                  + (f" — {s.get('reason', '')}"
                     if s["status"] == "skip" else ""))
            for row in s.get("rows", []) or []:
                line = ", ".join(f"{k}={v}" for k, v in row.items()
                                 if k not in ("status",))
                print(f"        [{row.get('status', '?')}] {line}")
            for p in s.get("problems", []) or []:
                print(f"        ! {p}")
        if unverified:
            print(f"verify-release: requested but missing (unverified): "
                  f"{', '.join(unverified)}")
        print(f"verify-release: {'PASS' if report['pass'] else 'FAIL'} "
              f"(executed: {', '.join(executed) or 'none'}; "
              f"report: {out / 'verify-release.json'})")
    return report
