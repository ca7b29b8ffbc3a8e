"""Port parity: a train-mode forward of the student against Flax.

The tiny fp32 student (``fc6_features=64, fc7_features=32``,
``dtype=float32`` on both sides), seeded weights with randomised running
statistics (``random_student_variables``), and a ``pad_mask`` that zeroes
two of four rows: the batch statistics come from the two real rows, the
running statistics move by ``0.9 * running + 0.1 * batch`` with the biased
variance. Logits and the updated ``batch_stats`` (mapped through the
bridge) within rtol 1e-5 of their scale; the JAX side runs at HIGHEST
matmul precision (its CPU convs otherwise take bf16 passes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_tpu.models.vggm import VGGMStudent as JaxVGGM
from mcncrossmodalemotions_torch.models.vggm import VGGMStudent, batch_norm_train
from mcncrossmodalemotions_torch.zoo import (
    random_student_variables,
    student_state_dict_from_flax,
)

TINY = dict(fc6_features=64, fc7_features=32)
RTOL = 1e-5


def _run(pad_mask):
    variables = random_student_variables(seed=5, **{"fc6": 64, "fc7": 32})
    x = np.random.RandomState(5).randn(4, 512, 200, 1).astype(np.float32)
    jm = JaxVGGM(dtype=jnp.float32, **TINY)
    kw = {} if pad_mask is None else {"pad_mask": jnp.asarray(pad_mask)}
    with jax.default_matmul_precision("highest"):
        jl, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"], **kw)
    tm = VGGMStudent(dtype=torch.float32, **TINY)
    tm.load_state_dict(student_state_dict_from_flax(variables))
    tkw = {} if pad_mask is None else {"pad_mask": torch.from_numpy(pad_mask)}
    with torch.no_grad():
        tl = tm(torch.from_numpy(x), train=True, **tkw)
    want = student_state_dict_from_flax(
        {"params": variables["params"], "batch_stats": mutated["batch_stats"]})
    return np.asarray(jl), tl.numpy(), tm.state_dict(), want, variables


@pytest.mark.parametrize("masked", [True, False])
def test_train_forward_and_batch_stats_match_flax(masked):
    mask = np.array([1, 0, 1, 0], np.float32) if masked else None
    jl, tl, got, want, before = _run(mask)
    assert tl.shape == jl.shape == (4, 8)
    assert np.abs(tl - jl).max() <= RTOL * np.abs(jl).max()
    moved = 0
    for i in range(1, 7):
        for stat in ("running_mean", "running_var"):
            key = f"bn{i}.{stat}"
            ref = want[key].numpy()
            assert np.abs(got[key].numpy() - ref).max() <= RTOL * np.abs(ref).max(), key
            old = before["batch_stats"][f"bn{i}"][stat.split("_")[1]]
            moved += int(not np.allclose(ref, old))
    assert moved == 12  # every statistic was updated


def test_masked_rows_do_not_touch_the_statistics():
    """Rows with pad_mask 0 may hold anything: the normalised real rows and
    the running statistics are those of the real rows alone."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 3, 5, 2).astype(np.float32))
    bn_a, bn_b = torch.nn.BatchNorm2d(3), torch.nn.BatchNorm2d(3)
    mask = torch.tensor([1.0, 0.0, 1.0, 0.0])
    ya = batch_norm_train(x, bn_a, mask)
    x2 = x.clone()
    x2[1] = 1e3
    x2[3] = -7.0
    yb = batch_norm_train(x2, bn_b, mask)
    assert torch.allclose(ya[mask > 0], yb[mask > 0], rtol=1e-6, atol=1e-6)
    assert torch.allclose(bn_a.running_var, bn_b.running_var, rtol=1e-6)
    real = x[mask > 0].permute(1, 0, 2, 3).reshape(3, -1)
    biased = real.var(dim=1, unbiased=False)
    assert torch.allclose(bn_a.running_var, 0.9 + 0.1 * biased, rtol=1e-5)
    assert torch.allclose(bn_a.running_mean, 0.1 * real.mean(dim=1), rtol=1e-5)


def test_bf16_train_bn_keeps_fp32_statistics():
    x = (torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0))
         * 3 + 10).bfloat16()
    bn = torch.nn.BatchNorm2d(4)
    y = batch_norm_train(x, bn)
    assert y.dtype == torch.bfloat16
    assert bn.running_mean.dtype == torch.float32
    xf = x.float().permute(1, 0, 2, 3).reshape(4, -1)
    assert torch.allclose(bn.running_mean, 0.1 * xf.mean(dim=1), rtol=1e-6)
