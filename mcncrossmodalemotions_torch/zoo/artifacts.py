"""Released-artifact registry: download on a miss, with integrity checks.

The port's copy of ``mcncrossmodalemotions_tpu/zoo/artifacts.py``. The
reference downloads its released models and prebuilt imdbs from
robots.ox.ac.uk on first use, after an interactive y/n prompt
(emoVoxZoo.m:74-102 fetchModel, fetch_emovoxceleb_imdb.m:288-324
fetchImdbFromInternet, teacher_stats.m:85-121 fetchLogitsFromInternet).
This module is the non-interactive equivalent: a URL table keyed by
artifact name, a cache-root convention, atomic downloads and sha256
integrity.

Both packages share the cache: the same ``MCN_TPU_ARTIFACT_ROOT`` variable,
the same default directory, the same ``<root>/<kind>/<filename>`` layout
and the same ``<file>.sha256`` sidecar (``"<sha256> <size>"``), so a
release placed by hand once serves both, and each verifies the other's
pins (``tests/test_torch_artifacts.py``).

The upstream publishes no checksums, so ``sha256`` entries are None until
pinned: the first successful load records the digest in the sidecar and
every later load checks against it. ``download=False`` never touches the
network and raises :class:`ArtifactUnavailable` with the URL and the
destination, or :func:`ensure_artifact` returns None where the artifact is
optional.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from pathlib import Path
from typing import Dict, Optional

_MODELS_URL = "http://www.robots.ox.ac.uk/~albanie/models"
_DATA_URL = "http://www.robots.ox.ac.uk/~albanie/data/cross-modal-emotions"


@dataclasses.dataclass(frozen=True)
class Artifact:
    name: str
    url: str
    filename: str
    kind: str  # 'model' | 'imdb'
    sha256: Optional[str] = None  # upstream publishes none; sidecar-pinned


ARTIFACTS: Dict[str, Artifact] = {
    a.name: a
    for a in (
        # released models (emoVoxZoo.m:25-31 names, :74-102 URL scheme:
        # .../models/{emovoxceleb|ferplus}/<name>.mat)
        Artifact("emovoxceleb-student",
                 f"{_MODELS_URL}/emovoxceleb/emovoxceleb-student.mat",
                 "emovoxceleb-student.mat", "model"),
        Artifact("resnet50-ferplus",
                 f"{_MODELS_URL}/ferplus/resnet50-ferplus.mat",
                 "resnet50-ferplus.mat", "model"),
        Artifact("senet50-ferplus",
                 f"{_MODELS_URL}/ferplus/senet50-ferplus.mat",
                 "senet50-ferplus.mat", "model"),
        # VGGFace2 base models (ferPlusZoo.m:37-42), the VGGFace2
        # MatConvNet release under the same models root
        Artifact("resnet50_ft-dag",
                 f"{_MODELS_URL}/vggface2/resnet50_ft-dag.mat",
                 "resnet50_ft-dag.mat", "model"),
        Artifact("resnet50_scratch-dag",
                 f"{_MODELS_URL}/vggface2/resnet50_scratch-dag.mat",
                 "resnet50_scratch-dag.mat", "model"),
        Artifact("senet50_ft-dag",
                 f"{_MODELS_URL}/vggface2/senet50_ft-dag.mat",
                 "senet50_ft-dag.mat", "model"),
        Artifact("senet50_scratch-dag",
                 f"{_MODELS_URL}/vggface2/senet50_scratch-dag.mat",
                 "senet50_scratch-dag.mat", "model"),
        # prebuilt imdbs / logit dumps (fetch_emovoxceleb_imdb.m:288-324,
        # teacher_stats.m:85-121)
        Artifact("voxceleb-imdb", f"{_DATA_URL}/voxceleb-imdb.mat",
                 "voxceleb-imdb.mat", "imdb"),
        Artifact("emovoxceleb-logits",
                 f"{_DATA_URL}/senet50-ferplus-logits.mat",
                 "senet50-ferplus-logits.mat", "imdb"),
        Artifact("afew-logits", f"{_DATA_URL}/afew-logits.mat",
                 "afew-logits.mat", "imdb"),
    )
}


class ArtifactUnavailable(RuntimeError):
    """Artifact missing locally and not downloadable (offline/denied)."""


class ArtifactCorrupt(ArtifactUnavailable):
    """Artifact present but failing its sha256 pin: not a benign miss.

    A subclass of :class:`ArtifactUnavailable`, so callers that skip a
    missing artifact still skip; the verify-release gate tells the two
    apart and fails on this one."""


def cache_root() -> Path:
    """Artifact cache directory (override: MCN_TPU_ARTIFACT_ROOT)."""
    env = os.environ.get("MCN_TPU_ARTIFACT_ROOT")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "mcncrossmodalemotions_tpu"


def artifact_path(name: str, root: Optional[str | Path] = None) -> Path:
    art = ARTIFACTS[name]
    base = Path(root) if root else cache_root()
    return base / art.kind / art.filename


def _file_sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _verify(path: Path, expected: Optional[str],
            full_check: bool = False) -> None:
    """Pin or check the artifact's sha256 and size through its sidecar.

    A repeat hit whose size matches the pin takes the size-only fast path
    (hashing a multi-GB release on every load costs seconds);
    ``full_check``, or a size change, re-hashes. An empty or garbled
    sidecar (a torn write) counts as no pin and is rewritten."""
    sidecar = path.with_suffix(path.suffix + ".sha256")
    size = path.stat().st_size
    if sidecar.exists():
        parts = sidecar.read_text().split()
        pinned = parts[0] if parts and len(parts[0]) == 64 else None
        try:
            pinned_size = int(parts[1]) if len(parts) > 1 else None
        except ValueError:
            pinned_size = None
        if pinned is None:
            digest = _file_sha256(path)
            if expected is not None and digest != expected:
                raise ArtifactCorrupt(
                    f"{path}: sha256 mismatch (got {digest}, expected "
                    f"{expected}) — delete the file to re-download")
            sidecar.write_text(f"{digest} {size}\n")
            return
        if pinned_size == size and not full_check:
            return  # fast path: size matches the pinned record
        digest = _file_sha256(path)
        if digest != pinned:
            raise ArtifactCorrupt(
                f"{path}: sha256 changed since first download "
                f"(got {digest}, pinned {pinned}) — the file is corrupt or "
                "was replaced; delete both to re-download")
        if pinned_size is None:  # upgrade a hash-only sidecar
            sidecar.write_text(f"{digest} {size}\n")
        return
    digest = _file_sha256(path)
    if expected is not None and digest != expected:
        raise ArtifactCorrupt(
            f"{path}: sha256 mismatch (got {digest}, expected {expected}) — "
            "delete the file to re-download")
    sidecar.write_text(f"{digest} {size}\n")


def fetch_artifact(name: str, root: Optional[str | Path] = None,
                   download: bool = True, timeout: float = 600.0,
                   full_check: bool = False) -> Path:
    """The local path of ``name``, downloaded on a miss.

    ``download=False`` never touches the network: a missing file raises
    :class:`ArtifactUnavailable` with the URL and the destination, for a
    transfer by hand. A download goes to a ``.part.<pid>`` file beside the
    destination (concurrent downloaders never write into one file) and is
    published by an atomic rename. ``full_check`` re-hashes against the
    pinned sidecar even where the size matches (the verify-release gate);
    a mismatch raises :class:`ArtifactCorrupt`.
    """
    if name not in ARTIFACTS:
        raise KeyError(f"unknown artifact {name!r}; known: "
                       f"{sorted(ARTIFACTS)}")
    art = ARTIFACTS[name]
    path = artifact_path(name, root)
    if path.exists():
        _verify(path, art.sha256, full_check=full_check)
        return path
    if not download:
        raise ArtifactUnavailable(
            f"{art.name} not found at {path} and downloads are disabled — "
            f"fetch {art.url} manually and place it there")
    import http.client
    import urllib.error
    import urllib.request

    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + f".part.{os.getpid()}")
    try:
        print(f"downloading {art.name} from {art.url} ...", flush=True)
        with urllib.request.urlopen(art.url, timeout=timeout) as resp, \
                open(tmp, "wb") as out:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
        tmp.replace(path)  # atomic publish
    except (urllib.error.URLError, http.client.HTTPException,
            OSError) as exc:
        # HTTPException covers failures mid-body (IncompleteRead)
        tmp.unlink(missing_ok=True)
        raise ArtifactUnavailable(
            f"could not download {art.name} from {art.url}: {exc} — "
            f"fetch it manually and place it at {path}") from exc
    _verify(path, art.sha256)
    return path


def ensure_artifact(name: str, root: Optional[str | Path] = None,
                    download: bool = True) -> Optional[Path]:
    """:func:`fetch_artifact`, or None when the artifact is unavailable:
    the skip for optional artifacts in offline runs."""
    try:
        return fetch_artifact(name, root, download=download)
    except ArtifactUnavailable as exc:
        print(f"[artifacts] {exc}", flush=True)
        return None
