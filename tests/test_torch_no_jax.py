"""The port imports no jax, flax or optax, not even indirectly.

tests/conftest.py imports jax, so the check runs in a fresh interpreter:
it imports every module of ``mcncrossmodalemotions_torch``, runs the tiny
extraction slice and the tiny pipeline on the CPU, and then inspects
``sys.modules``.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys, tempfile
    from pathlib import Path

    import torch

    import mcncrossmodalemotions_torch as pkg
    for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(mod.name)

    from mcncrossmodalemotions_torch.data import synthetic_track_imdb
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        compute_audio_feats)
    from mcncrossmodalemotions_torch.zoo import (
        build_student, random_student_variables, student_state_dict_from_flax)

    v = random_student_variables(seed=0, fc6=64, fc7=32)
    with tempfile.TemporaryDirectory() as d:
        imdb = synthetic_track_imdb(Path(d), durations=(1.2,),
                                    tracks_per_class=1)
        logits = compute_audio_feats(
            imdb, build_student(tiny=True, with_frontend=False),
            student_state_dict_from_flax(v), batch_size=3, verbose=False)
    assert len(logits) == 6 and all(l.shape == (1, 8) for l in logits)
    pipe = build_student(tiny=True).eval()
    pipe.load_state_dict(student_state_dict_from_flax(
        {"params": {"net": v["params"]},
         "batch_stats": {"net": v["batch_stats"]}}))
    with torch.inference_mode():
        out = pipe(torch.randn(2, 16384, generator=torch.Generator().manual_seed(0)))
    assert out.shape == (2, 8) and bool(torch.isfinite(out).all())

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
    assert not leaked, leaked
    print("NO_JAX_OK")
""")


def test_torch_package_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout
