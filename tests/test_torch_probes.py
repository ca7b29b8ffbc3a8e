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
branches fire, through the JAX probe's own kernel. The paths the gather
and P12's expansion take on the card (16-byte vectors or one element a
thread, 32- or 64-bit offsets) are chosen on the host by plain functions,
tested here; the card's tests hold the built launchers to them.
"""

import functools
import importlib.util
import json
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
    time_probes,
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


@pytest.mark.parametrize("itemsize,inner,x_off,out_off,vec", [
    (4, 96, 0, 0, 4), (4, 4, 0, 0, 4), (4, 96, 4, 0, 1), (4, 96, 0, 8, 1),
    (4, 1, 0, 0, 1), (4, 31, 0, 0, 1), (4, 6, 0, 0, 1),
    (2, 96, 0, 0, 8), (2, 8, 16, 32, 8), (2, 12, 0, 0, 1), (2, 4, 0, 0, 1),
    (2, 96, 2, 0, 1), (2, 96, 0, 4, 1)])
def test_gather_route_vector_width(itemsize, inner, x_off, out_off, vec):
    """16 bytes a thread where inner is a multiple of the vector width (4
    f32, 8 bf16) and both base pointers are 16-byte aligned; else one
    element a thread."""
    got = probes.gather_route(4096 + x_off, 8192 + out_off, itemsize, 3, 7, 9,
                              inner)
    assert got == probes.Route(vec, False)


@pytest.mark.parametrize("outer,n_in,n_out,inner,wide", [
    (16, 100, 197, 96, False), (1, 2 ** 31 - 1, 1, 1, False),
    (1, 1, 2 ** 31 - 1, 1, False), (2, 2 ** 30, 1, 1, True),
    (1, 3, 2 ** 30, 2, True), (1, 4, 4, 2 ** 29 - 1, False),
    (1, 4, 4, 2 ** 29, True), (2 ** 31, 1, 1, 1, True)])
def test_gather_route_offset_width(outer, n_in, n_out, inner, wide):
    """32-bit offsets while x and out both hold fewer than 2^31 elements."""
    assert probes.gather_route(0, 0, 4, outer, n_in, n_out, inner).wide is wide


@pytest.mark.parametrize("c,offsets,vec", [
    (96, (0, 0, 0, 0), 4), (4, (0, 0, 0, 0), 4), (5, (0, 0, 0, 0), 1),
    (6, (0, 0, 0, 0), 1), (96, (4, 0, 0, 0), 1), (96, (0, 8, 0, 0), 1),
    (96, (0, 0, 12, 0), 1), (96, (0, 0, 0, 4), 1), (96, (16, 32, 48, 64), 4)])
def test_col_candidates_route_vector_width(c, offsets, vec):
    ptrs = [4096 * (k + 1) + off for k, off in enumerate(offsets)]
    assert probes.col_candidates_route(*ptrs, 16, 197, 100, c) == probes.Route(
        vec, False)


@pytest.mark.parametrize("t,w,wh,c,wide", [
    (16, 197, 100, 96, False), (1, 2 ** 31 - 1, 2 ** 30 + 1, 1, False),
    (2, 2 ** 30, 2 ** 29 + 1, 1, True), (1, 9, 2 ** 31 - 1, 1, False),
    (2 ** 21, 8, 8, 128, True), (2 ** 21 - 1, 8, 8, 128, False)])
def test_col_candidates_route_offset_width(t, w, wh, c, wide):
    assert probes.col_candidates_route(0, 0, 0, 0, t, w, wh, c).wide is wide


def test_every_probe_takes_its_expected_path():
    """At 16-byte aligned pointers (a fresh tensor's), every probe is
    narrow; the gathers along a lane axis (inner 1) and the reshapes take
    one element a thread, the others 16-byte vectors; P12 float4."""
    vector = {"P2 2D sublane gather", "P3 3D sublane gather",
              "P4 3D sublane repeat", "P6 2D sublane repeat",
              "P4r 3D sublane repeat (Wh=100,C=96)",
              "P4s shifted sublane repeat", "P4b 3D sublane repeat bf16"}
    seen = 0
    for p in probe_mosaic.make_probes(CPU) + probe_mosaic2.make_probes(CPU):
        if p.kernel is probes.probe_gather:
            x, index, axis = p.args
            outer, inner = probes.gather_dims(x.shape, axis)
            got = probes.gather_route(0, 0, x.element_size(), outer,
                                      index.n_in, index.values.numel(), inner)
            want = 16 // x.element_size() if p.name in vector else 1
        elif p.kernel is probes.probe_col_candidates:
            x, y, _ = p.args
            got = probes.col_candidates_route(0, 0, 0, 0, *x.shape[:2],
                                              y.shape[1], x.shape[2])
            want = 4
        else:
            continue
        seen += 1
        assert got == probes.Route(want, False), p.name
    assert seen == 16


@pytest.mark.parametrize("shape,axis,dims", [
    ((16, 256), 1, (16, 1)), ((16, 256), 0, (1, 256)), ((8, 16, 128), -2, (8, 128)),
    ((16384,), 0, (1, 1)), ((2, 3, 5, 7), 2, (6, 7))])
def test_gather_dims(shape, axis, dims):
    assert probes.gather_dims(shape, axis) == dims


def test_time_probes_rehearses_on_the_cpu(capsys):
    """The timing tool's flow on the CPU: a record a probe, no path (the
    wrappers take their plain versions), the bytes bound of each, the sums
    by kernel printed."""
    records = time_probes.main("cpu", iters=1)
    rows = records["this"]["probes"]
    assert [r["name"] for r in rows] == NAMES
    assert all(r["path"] is None and r["bound_ms"] > 0 for r in rows)
    assert [r["library_ms"] is None for r in rows].count(True) == 1  # P12
    out = capsys.readouterr().out
    assert "probe_gather: 15 launch(es)" in out
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(
        json.dumps(records))


def test_time_probes_against_a_checkout_in_turns(monkeypatch, capsys):
    """Against another tree: four workers in turns (it, this, this, it),
    each tree's two runs averaged."""
    order = []

    def fake(tree, device, iters):
        order.append(tree)
        k = len(order)
        return {"package": str(tree), "floor_ms": float(k), "probes": [
            {"name": "P", "kernel": "probe_gather", "path": [4, False],
             "kernel_ms": 10.0 * k, "plain_ms": 1.0, "library_ms": None,
             "bound_ms": 0.5}]}

    monkeypatch.setattr(time_probes, "_worker", fake)
    records = time_probes.main("cpu", iters=1, against=REPO / "build")
    assert order == [REPO / "build", REPO, REPO, REPO / "build"]
    assert records["against"]["probes"][0]["kernel_ms"] == 25.0
    assert records["this"]["probes"][0]["kernel_ms"] == 25.0
    assert records["this"]["floor_ms"] == 2.5
    assert "against 25.00000 ms" in capsys.readouterr().out


def test_time_probes_worker_imports_the_trees_package():
    """A worker process times the package of the tree it is given."""
    record = time_probes._worker(REPO, "cpu", 1)
    assert record["package"] == str(REPO / "mcncrossmodalemotions_torch")
    assert [r["name"] for r in record["probes"]] == NAMES
