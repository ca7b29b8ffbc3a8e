"""The port's step, pool and FER+ studies (the counterparts of eight tools
of ``tools/``) on the CPU at small sizes.

Each study's ``main(device="cpu", ...)`` returns its records under the JAX
tool's names (the row and variant names are read back from the JAX tool's
source): the step studies (``ab_step_conv1``, ``probe_masked_bn``,
``probe_remat``) one form each, as their one-form-a-process command lines
run them; ``profile_train_step``'s ablations; ``probe_conv1_s2d``'s parity
of the two conv1 forms; ``probe_pool_compose``'s and ``bench_pool_bwd``'s
exactness; ``ablate_ferplus_resample``'s chains. On the CPU every kernel
wrapper runs its plain version, so no launch is counted. Without a card
each study's default device raises, and each command line exits non-zero.
"""

import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mcncrossmodalemotions_torch.tools import (
    ab_step_conv1,
    ablate_ferplus_resample,
    bench_pool_bwd,
    probe_conv1_s2d,
    probe_masked_bn,
    probe_pool_compose,
    probe_remat,
    profile_train_step,
)

REPO = Path(__file__).resolve().parent.parent
STEP = dict(batch_size=2, num_frames=100, tiny=True, iters=1)
NO_LAUNCHES = {"spectrogram": 0, "max_pool_3x3s2": 0, "max_pool_3x3s2_idx": 0,
               "max_pool_3x3s2_bwd": 0}
STUDIES = ("profile_train_step", "probe_masked_bn", "ab_step_conv1",
           "probe_conv1_s2d", "probe_remat", "probe_pool_compose",
           "bench_pool_bwd", "ablate_ferplus_resample")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_source(name: str) -> str:
    return (REPO / "tools" / f"{name}.py").read_text()


@pytest.mark.parametrize("study,form,key", [
    (ab_step_conv1, "plain", "conv1"), (ab_step_conv1, "s2d", "conv1"),
    (probe_masked_bn, "baseline", "variant"),
    (probe_masked_bn, "masked", "variant"),
    (probe_remat, "none", "policy"), (probe_remat, "nothing", "policy")],
    ids=lambda v: getattr(v, "__name__", str(v)).split(".")[-1])
def test_step_studies_time_one_form(study, form, key):
    """One form a call, named as the JAX tool names it, with a positive
    step time and utts/s consistent with it."""
    if study is probe_remat:
        rec = study.main(form, 2, "cpu", iters=1, num_frames=100, tiny=True)
        assert rec["peak_gib"] is None and rec["held_gib"] is None  # n/a
        assert rec["batch_size"] == 2
    else:
        rec = study.main(form, "cpu", **STEP)
    assert rec[key] == form and form in _jax_source(study.__name__.split(".")[-1])
    assert rec["ms"] > 0
    assert math.isclose(rec["utts_per_sec"], 2 / rec["ms"] * 1000, rel_tol=1e-2)
    assert rec["launches"] == NO_LAUNCHES


def test_profile_train_step_rows_are_the_jax_tools():
    full = profile_train_step.main("cpu", **STEP)
    quick = profile_train_step.main("cpu", quick=True, **STEP)
    rows = [k for k in full if k != "launches"]
    assert rows == ["full train step", "frontend (spectrogram+instnorm)",
                    "train step, precomputed spec", "forward only (test mode)",
                    "value_and_grad (no SGD update)", "train step, no batchnorm",
                    "train step, avg-pool for max-pool",
                    "conv1..conv1 (+pool/bn) fwd+bwd",
                    "conv1..conv2 (+pool/bn) fwd+bwd"]
    src = _jax_source("profile_train_step")
    for row in rows[:7]:
        assert f'"{row}"' in src, row
    assert 'f"conv1..conv{n} (+pool/bn) fwd+bwd"' in src
    assert [k for k in quick if k != "launches"] == rows[:6]
    assert all(full[r] > 0 for r in rows)
    assert full["launches"] == NO_LAUNCHES


def test_probe_conv1_s2d_forms_agree():
    """The two conv1 forms within chip_smoke's gates (fp32 with TF32 off:
    1e-5 x max|y|; bf16: 1e-2 x max|y|) and timed under the JAX names."""
    rec = probe_conv1_s2d.main("cpu", batch_size=2, height=64, width=50,
                               iters=1)
    assert rec["shapes"] == [[2, 96, 29, 22]] * 2
    assert rec["max_abs_diff_fp32"] <= 1e-5 * rec["max_abs_y_fp32"]
    assert rec["max_abs_diff"] <= 1e-2 * rec["max_abs_y"]
    src = _jax_source("probe_conv1_s2d")
    for name in (probe_conv1_s2d.BASE, probe_conv1_s2d.S2D):
        assert f'"{name}"' in src
        assert rec[name]["fwd_ms"] > 0 and rec[name]["fwd+bwd_ms"] > 0
    assert rec["speedup_fwd+bwd"] == pytest.approx(
        rec[probe_conv1_s2d.BASE]["fwd+bwd_ms"]
        / rec[probe_conv1_s2d.S2D]["fwd+bwd_ms"])


def test_pool_studies_are_exact():
    """The composition's forward is the direct pool's bitwise (and, on
    float32 inputs without ties, its backward too); the student's pool
    against autograd of ``F.max_pool2d``: y bitwise at the JAX tool's
    shapes, dx bitwise in float32 (the CPU's bf16 autograd sums in bf16,
    the card's in fp32 as the kernel does: chip_smoke holds the card's
    bf16 dx bitwise)."""
    comp = probe_pool_compose.main("cpu", shape=(2, 21, 19, 8), iters=1)
    assert comp["fwd_bitwise"] and comp["fwd_max_abs_diff"] == 0.0
    assert comp["bwd_bitwise"]
    for row in probe_pool_compose.ROWS:
        assert comp[row]["fwd_ms"] > 0 and comp[row]["fwd_bwd_ms"] > 0
    assert comp["launches"] == NO_LAUNCHES

    shapes = bench_pool_bwd.NUMERICS_SHAPES[:2]
    rec = bench_pool_bwd.main("cpu", numerics_shapes=shapes,
                              timed_shapes=(("pool1", (2, 21, 19, 8)),),
                              iters=1)
    assert [r["shape"] for r in rec["numerics"]] == [
        list(s) for s in shapes + (bench_pool_bwd.GRAD_SHAPE,)]
    assert all(r["fwd_exact"] for r in rec["numerics"])
    assert rec["numerics"][-1] == {"shape": list(bench_pool_bwd.GRAD_SHAPE),
                                   "dtype": "float32", "fwd_exact": True,
                                   "grad_exact": True}
    assert [r["impl"] for r in rec["timing"]] == ["F.max_pool2d", "k2"]
    assert all(r["fwd_ms"] > 0 and r["fwd_bwd_ms"] > 0 for r in rec["timing"])
    assert rec["launches"] == NO_LAUNCHES
    assert bench_pool_bwd.NUMERICS_SHAPES == ((2, 21, 19, 96), (2, 34, 46, 8),
                                              (128, 253, 197, 96))


def test_ablate_ferplus_resample_reports_both_chains():
    rec = ablate_ferplus_resample.main("cpu", seeds=(0,), num_images=48,
                                       epochs=1, batch_size=8, input_size=48,
                                       augment_reps=1)
    src = _jax_source("ablate_ferplus_resample")
    for chain in (ablate_ferplus_resample.CHAIN_A,
                  ablate_ferplus_resample.CHAIN_B):
        assert f'"{chain}"' in src
        assert len(rec["accuracy"][chain]) == 1
        assert 0.0 <= rec["accuracy"][chain][0] <= 1.0
    assert list(rec["host_augment_ms"]) == ["warp@48 (a)", "warp->96",
                                            "warp->224 (b)"]
    assert rec["delta_b_minus_a"] == pytest.approx(
        rec["mean"][ablate_ferplus_resample.CHAIN_B]
        - rec["mean"][ablate_ferplus_resample.CHAIN_A])


def test_studies_run_on_the_card_unless_asked():
    """Without a card the default device raises before any work, in the
    function and at the command line (exit code non-zero)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    calls = [lambda: profile_train_step.main(),
             lambda: probe_masked_bn.main("baseline"),
             lambda: ab_step_conv1.main("plain"),
             lambda: probe_conv1_s2d.main(), lambda: probe_remat.main("none"),
             lambda: probe_pool_compose.main(), lambda: bench_pool_bwd.main(),
             lambda: ablate_ferplus_resample.main()]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
    args = {"probe_masked_bn": ["baseline"], "ab_step_conv1": ["plain"],
            "probe_remat": ["none"]}
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"mcncrossmodalemotions_torch.tools.{name}",
         *args.get(name, [])], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name in STUDIES]
    for name, proc in zip(STUDIES, procs):
        out, err = proc.communicate(timeout=120)
        assert proc.returncode != 0, name
        assert "CUDA device" in err and not out.strip().startswith("{"), name
