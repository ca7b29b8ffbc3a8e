"""The Hopper probes against the JAX package's Mosaic probes, on the CPU.

The JAX tools (``tools/probe_mosaic.py``, ``tools/probe_mosaic2.py``, left
as they are) run here with ``pl.pallas_call`` wrapped into interpret mode
and ``run_probe`` wrapped to record each probe's output. P1, P2, P3, P9
and P11 close over a constant index table or selection matrix, which
interpret mode refuses ("captures constants"); for those the JAX side is
the kernel body's own op outside ``pallas_call`` (``jnp.take``, or
``lax.dot_general`` at HIGHEST precision), held to the tool's numpy
``expect``. Each probe of the port, on a CPU tensor its kernel's plain
version, must give the JAX output bit for bit, from the same numpy
``expect``. P12 runs again on small-integer inputs, where both candidate
branches fire, through the JAX probe's own kernel.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mcncrossmodalemotions_torch.ops import probes
from mcncrossmodalemotions_torch.tools import (
    Probe,
    exit_code,
    probe_mosaic,
    probe_mosaic2,
    run_probe,
)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")

IDX_L = np.repeat(np.arange(128), 2).astype(np.int32)
IDX_S = np.repeat(np.arange(8), 2).astype(np.int32)
IDX_W = np.repeat(np.arange(8), 2).astype(np.int32)
IDX_C = np.repeat(np.arange(64), 2).astype(np.int32)
SEL = np.zeros((128, 256), np.float32)
SEL[IDX_L, np.arange(256)] = 1.0
# the kernel bodies of the probes that interpret mode refuses
BODIES = {
    "P1 2D lane gather": lambda x: jnp.take(x, IDX_L, axis=1),
    "P2 2D sublane gather": lambda x: jnp.take(x, IDX_S, axis=0),
    "P3 3D sublane gather": lambda x: jnp.take(x, IDX_W, axis=1),
    "P9 lane selection matmul": lambda x: jax.lax.dot_general(
        x[:, :128], jnp.asarray(SEL), (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32),
    "P11 3D lane gather": lambda x: jnp.take(x, IDX_C, axis=2),
}
P12 = "P12 full col-candidate expansion"


def _ties(shape_x, shape_y):
    """P12's inputs drawn from {0, 1, 2}, so x == y holds often."""
    rng = np.random.RandomState(3)
    return (rng.randint(0, 3, shape_x).astype(np.float32),
            rng.randint(0, 3, shape_y).astype(np.float32),
            rng.randn(*shape_y).astype(np.float32))


@pytest.fixture(scope="module")
def jax_probes():
    """{name: (output or None, expect, args, error)} from both JAX tools
    under interpret mode, plus P12's output on the tie-heavy inputs."""
    records = {}

    def record(name, fn, *args, expect=None):
        try:
            out, err = np.asarray(jax.jit(fn)(*args)), None
        except Exception as exc:  # recorded, then judged by the test
            out, err = None, str(exc)
        records[name] = (out, expect, args, err)
        if name == P12:
            records["P12 ties"] = np.asarray(jax.jit(fn)(*_ties(
                args[0].shape, args[1].shape)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        for stem in ("probe_mosaic", "probe_mosaic2"):
            spec = importlib.util.spec_from_file_location(
                f"_jax_{stem}", REPO / "tools" / f"{stem}.py")
            tool = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(tool)
            mp.setattr(tool, "run_probe", record)
            tool.main()
    return records


@pytest.fixture(scope="module")
def port_probes():
    return {p.name: p for p in (probe_mosaic.make_probes(CPU)
                                + probe_mosaic2.make_probes(CPU))}


NAMES = [p.name for p in probe_mosaic.make_probes(CPU)
         + probe_mosaic2.make_probes(CPU)]


def test_the_port_has_the_jax_tools_probes(jax_probes):
    assert len(NAMES) == 17
    assert sorted(NAMES) == sorted(k for k in jax_probes if k != "P12 ties")


@pytest.mark.parametrize("name", NAMES, ids=lambda n: n.split()[0])
def test_probe_bitwise_equal_to_jax(jax_probes, port_probes, name):
    out, expect, args, err = jax_probes[name]
    if err is not None:
        assert name in BODIES and "captures constants" in err, err
        out = np.asarray(jax.jit(BODIES[name])(*args))
        np.testing.assert_array_equal(out, expect)
    probe = port_probes[name]
    got = probe.run().numpy()
    assert got.dtype == out.dtype == np.float32
    assert got.shape == out.shape == probe.expect.shape
    np.testing.assert_array_equal(got.view(np.int32), out.view(np.int32))
    np.testing.assert_array_equal(probe.expect, np.asarray(expect, np.float32))


def test_interpret_mode_runs_every_probe_without_constants(jax_probes):
    refused = {n for n, r in jax_probes.items()
               if n != "P12 ties" and r[3] is not None}
    assert refused <= set(BODIES)


def test_p12_on_ties_bitwise_equal_to_jax_with_both_branches(jax_probes):
    t, w, c, wh = probe_mosaic2.T, probe_mosaic2.W, probe_mosaic2.C, probe_mosaic2.WH
    x, y, dy = _ties((t, w, c), (t, wh, c))
    got = probes.probe_col_candidates(*map(torch.from_numpy, (x, y, dy))).numpy()
    ref = jax_probes["P12 ties"]
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    even = (np.arange(w) % 2 == 0)[None, :, None]
    for k2 in (0, 1):
        yc = np.repeat(y[:, 1 - k2:], 2, axis=1)[:, :w]
        fired = (x == yc) & (even if k2 else True)
        assert fired.mean() > 0.05, k2
    assert (got != 0).mean() > 0.05


def test_wrappers_on_the_cpu_take_the_plain_versions():
    x = torch.arange(12.0).view(3, 4)
    counts = (probes.probe_gather.launches, probes.probe_select_matmul.launches,
              probes.probe_col_candidates.launches)
    index = probes.index_map([3, 0, 0], 4, CPU)
    assert torch.equal(probes.probe_gather(x, index, -1), x[:, [3, 0, 0]])
    assert torch.equal(probes.probe_gather(x.bfloat16(), index, 1),
                       x[:, [3, 0, 0]])
    assert torch.equal(probes.probe_select_matmul(x, torch.eye(4)), x)
    out = probes.probe_col_candidates(torch.zeros(1, 3, 2), torch.zeros(1, 3, 2),
                                      torch.ones(1, 3, 2))
    assert out.tolist() == [[[2.0, 2.0], [1.0, 1.0], [2.0, 2.0]]]
    assert (probes.probe_gather.launches, probes.probe_select_matmul.launches,
            probes.probe_col_candidates.launches) == counts


@pytest.mark.parametrize("idx,n_in,error", [
    ([0, 4], 4, IndexError), ([-1], 4, IndexError), ([], 4, ValueError),
    ([[0, 1]], 4, ValueError), ([0.5], 4, ValueError)])
def test_index_map_checks_indices_on_the_host(idx, n_in, error):
    with pytest.raises(error):
        probes.index_map(np.asarray(idx), n_in, CPU)


def test_wrappers_refuse_mismatched_shapes():
    x = torch.zeros(3, 5)
    with pytest.raises(ValueError):
        probes.probe_gather(x, probes.index_map([0], 3, CPU), 1)
    with pytest.raises(ValueError):
        probes.probe_select_matmul(x, torch.zeros(4, 2))
    with pytest.raises(ValueError):  # 2 (Wh - 1) < W: the repeat is short
        probes.probe_col_candidates(torch.zeros(2, 9, 3), torch.zeros(2, 5, 3),
                                    torch.zeros(2, 5, 3))


def test_a_failing_probe_is_reported(capsys):
    def broken(*_):
        raise RuntimeError("illegal address\nsecond line")

    bad = Probe("PX broken", broken, broken, (), np.zeros(1, np.float32))
    good = Probe("PY fine", probes.gather, probes.gather,
                 (torch.ones(2), probes.index_map([1], 2, CPU), 0),
                 np.ones(1, np.float32))
    assert run_probe(bad) == (False, False)
    assert run_probe(good) == (True, True)
    out = capsys.readouterr().out
    assert "PROBE PX broken: FAIL — illegal address | second line" in out
    assert "PROBE PY fine: RUNS, match=True" in out
    assert exit_code({"a": (True, True), "b": (True, False)}) == 1


def test_tools_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (probe_mosaic, probe_mosaic2):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tool.main()
