"""Data parallelism of the port (``parallel/mesh.py``) on the CPU.

Without extra processes:

- ``pad_to_multiple`` equals the JAX package's, under hypothesis;
- ``make_mesh`` refuses a group of another size than asked for, and a
  process without a group; ``auto_mesh``'s rule (None in one process,
  every rank when the world size divides the batch, else an error);
- ``shard_batch`` keeps the rank's contiguous rows;
- ``initialize_multihost`` hands its arguments, or ``torchrun``'s
  environment, to ``init_process_group`` and does nothing at one process;
- the ranks' dropout and fliplr draws, made at the global shape, put
  together are one process's draws.

With two processes: this file starts itself as the worker of each rank
(``python tests/test_torch_parallel.py <rank> <world> <port> <out>
<scenario> <data>``), joined by ``initialize_multihost`` over gloo on
``127.0.0.1``, two torch threads each, each run bounded by its own
timeout and a spawn retried only on bind-shaped failures (the free-port
probe is bind-then-close). Everything runs in float64 on tiny configs:

- ``steps``: the offline student step through ``Trainer`` (full batches
  with dropout drawn at the global shape; full batches, a ragged batch of
  5 rows and a batch whose rank-1 shard is all padding, without dropout),
  the online (fused-teacher) step, and the tiny SENet teacher pipeline
  (fliplr, dropout, the backbone's lr at 0.1) through ``Trainer``;
- ``fit``: ``Trainer.fit`` for 2 epochs on 2 ranks resumed by one process
  for a third, a one-process run of 2 epochs resumed by 2 ranks,
  ``compute_visual_feats`` on 2 ranks, and a tiny ``run_distillation``
  epoch at its default ``mesh="auto"`` (bf16: held to one process within
  the 1e-2 of ``chip_smoke.py``'s train gate).

The two ranks are held bitwise equal to each other, and against the port
in one process on the whole batch:

- the global masked BatchNorm alone (``batch_norm_train`` forward and
  backward, a shard of padding rows among them), float64 end to end,
  within 1e-10 (the sums over ranks add in another order);
- the train steps and the dense logits within 1e-6 of each tensor's
  largest magnitude. The student's head and pool6, and the teachers'
  global pool and head, run in fp32 whatever the parameters' dtype (as the
  JAX modules fix them), so the head's gradient summed in two halves, or
  a head's product over 2 rows instead of 4, rounds differently by about
  fp32's epsilon (1.2e-7), which the next steps carry everywhere: measured
  up to 7e-8 (student), 2.1e-7 (teacher) and 2.4e-7 (dense logits) of the
  largest magnitude;
- the student's 4 steps also against the JAX package's ``Trainer`` under
  ``make_mesh(2)`` at ``tests/test_torch_train_step.py``'s tolerance.

Only rank 0 writes checkpoints, ``metrics.jsonl`` and the feature cache.
"""

from __future__ import annotations

import faulthandler
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.exp import compute_visual_feats as tvf
from mcncrossmodalemotions_torch.models.resnet import ResNet
from mcncrossmodalemotions_torch.models.teacher_pipeline import (
    FaceTeacherPipeline,
    random_flip,
)
from mcncrossmodalemotions_torch.models.vggm import VGGMStudent, dropout
from mcncrossmodalemotions_torch.parallel import mesh as pmesh
from mcncrossmodalemotions_torch.train import checkpoints as ckpt_lib
from mcncrossmodalemotions_torch.train.distill import make_online_distill_step
from mcncrossmodalemotions_torch.train.engine import TrainConfig, Trainer
from mcncrossmodalemotions_torch.train.state import (
    SGDConfig,
    finetune_lr_scale_fn,
)
from mcncrossmodalemotions_torch.zoo import student_loss_fn, teacher_loss_fn

REPO = Path(__file__).resolve().parent.parent
TINY_STUDENT = dict(fc6_features=64, fc7_features=32)
TINY_RESNET = dict(stage_sizes=(1, 1), width=8, use_se=True)
FRAMES = 80        # spectrogram columns: the least the student's pools take
FACE = 32          # the teacher pipeline's input size
LR = 1e-2
WD = 5e-4
TOL = 1e-10        # float64: the same sums, added over ranks in another order
FP32_TOL = 1e-6    # of a tensor's max: the fp32 heads, summed over other rows
WORKER_TIMEOUT = 180  # seconds a rank may take (its own bound, then exit)
F64 = torch.float64


# -- the scenarios: one process (mesh None) or one rank of a mesh ----------

def _batch(rng, n, mask=None):
    b = {"data": rng.randn(n, 512, FRAMES, 1) * 0.5,
         "logit_target": rng.randn(n, 8) * 2,
         "max_label": rng.randint(0, 8, n)}
    if mask is not None:
        b["pad_mask"] = np.float32(mask)
    return b


def student_batches(seed: int = 0) -> list:
    """Two full batches, a ragged one of 5 rows (padded to 6 on 2 ranks)
    and one whose rank-1 shard is all padding."""
    rng = np.random.RandomState(seed)
    return [_batch(rng, 4), _batch(rng, 4), _batch(rng, 5),
            _batch(rng, 4, mask=[1, 1, 0, 0])]


def online_batches(seed: int = 1) -> list:
    rng = np.random.RandomState(seed)
    return [{"data": rng.randn(4, 512, FRAMES, 1) * 0.5,
             "frames": rng.randint(0, 256, (4, 2, FACE, FACE, 1), np.uint8)}
            for _ in range(2)]


def face_batches(seed: int = 2) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        votes = rng.rand(4, 8)
        dist = votes / votes.sum(-1, keepdims=True)
        out.append({"data": rng.randint(0, 256, (4, FACE, FACE, 1), np.uint8),
                    "label_dist": dist, "hard_label": dist.argmax(-1)})
    return out


def fit_batches(epoch: int) -> list:
    rng = np.random.RandomState(10 + epoch)
    return [_batch(rng, 4), _batch(rng, 3)]


def _cfg(**kw) -> TrainConfig:
    return TrainConfig(**dict(dict(learning_rate=LR, weight_decay=WD,
                                   log_every=1000, resume=False), **kw))


def _flat(state) -> dict:
    out = {f"model.{k}": v.detach().numpy().copy()
           for k, v in state.model.state_dict().items()}
    out.update({f"velocity.{k}": v.detach().numpy().copy()
                for k, v in state.velocity.items()})
    out["step"] = np.asarray(state.step)
    return out


def _student(weights: dict, dropout_rate: float = 0.0) -> VGGMStudent:
    model = VGGMStudent(dtype=F64, dropout_rate=dropout_rate, **TINY_STUDENT)
    model.load_state_dict(weights["student"], strict=True)
    return model.to(F64)


def _steps(trainer: Trainer, state, batches) -> tuple:
    losses = []
    for b in batches:
        state, stats = trainer.run_epoch(state, [b], epoch=1)
        losses.append(stats["loss"])
    return state, losses


def run_student(weights: dict, mesh=None, dropout_rate: float = 0.0) -> dict:
    """4 steps without dropout, or the 2 full batches with it."""
    batches = student_batches()
    if dropout_rate:
        batches = batches[:2]
    trainer = Trainer(_student(weights, dropout_rate),
                      student_loss_fn("hot-cross-ent", temperature=2.0),
                      _cfg(), device="cpu", mesh=mesh)
    state, losses = _steps(trainer, trainer.init_state(scratch=False), batches)
    return dict(_flat(state), losses=np.asarray(losses))


def _teacher(weights: dict, augment: bool, dropout_rate: float):
    pipe = FaceTeacherPipeline(ResNet(dtype=F64, dropout_rate=dropout_rate,
                                      **TINY_RESNET),
                               input_size=FACE, augment=augment)
    pipe.load_state_dict(weights["teacher"], strict=True)
    return pipe.to(F64)


def run_bn(mesh=None) -> dict:
    """``batch_norm_train`` forward and backward in float64 over a batch of
    4 rows whose last two are padding (rank 1's whole shard on 2 ranks):
    the output rows, the gradients of a loss over the valid rows (none
    reaches a padding row: the statistics are the valid rows') and the
    running statistics."""
    from mcncrossmodalemotions_torch.models.vggm import batch_norm_train

    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(4, 3, 5, 6) * 2 + 1)
    dy = torch.from_numpy(rng.randn(4, 3, 5, 6))
    mask = torch.tensor([1.0, 1.0, 0.0, 0.0])
    rows = slice(None) if mesh is None else mesh.rows(4)
    bn = torch.nn.BatchNorm2d(3).to(F64)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.rand(3) + 0.5))
        bn.bias.copy_(torch.from_numpy(rng.randn(3)))
    xs = x[rows].clone().requires_grad_(True)
    y = batch_norm_train(xs, bn, mask[rows], mesh=mesh)
    loss = (y * dy[rows] * mask[rows, None, None, None]).sum()
    gx, gw, gb = torch.autograd.grad(loss, (xs, bn.weight, bn.bias))
    if mesh is not None:
        y, gx = (pmesh.gather_rows(t.detach(), mesh) for t in (y, gx))
        gw, gb = pmesh.all_reduce_tensors([gw, gb], mesh)
    return {k: v.detach().numpy() for k, v in dict(
        y=y, gx=gx, gw=gw, gb=gb, mean=bn.running_mean,
        var=bn.running_var).items()}


def run_online(weights: dict, mesh=None) -> dict:
    step = make_online_distill_step(_teacher(weights, False, 0.0),
                                    sgd=SGDConfig(weight_decay=WD), mesh=mesh)
    trainer = Trainer(_student(weights), student_loss_fn(), _cfg(),
                      device="cpu", train_step_override=step, mesh=mesh)
    state, losses = _steps(trainer, trainer.init_state(scratch=False),
                           online_batches())
    return dict(_flat(state), losses=np.asarray(losses))


def run_teacher(weights: dict, mesh=None) -> dict:
    trainer = Trainer(_teacher(weights, True, 0.5),
                      teacher_loss_fn("distributions"), _cfg(), device="cpu",
                      lr_scale_fn=finetune_lr_scale_fn(backbone_scale=0.1),
                      mesh=mesh)
    state, losses = _steps(trainer, trainer.init_state(scratch=False),
                           face_batches())
    return dict(_flat(state), losses=np.asarray(losses))


def run_fit(weights: dict, exp_dir: Path, num_epochs: int, mesh=None) -> dict:
    """``Trainer.fit`` (resuming ``exp_dir``) to ``num_epochs``; the
    checkpoint saves this process made ride along."""
    saves = []
    save = ckpt_lib.save_checkpoint

    def counted(*args, **kwargs):
        saves.append(args[1])
        return save(*args, **kwargs)

    ckpt_lib.save_checkpoint = counted
    try:
        trainer = Trainer(_student(weights),
                          student_loss_fn("hot-cross-ent", temperature=2.0),
                          _cfg(num_epochs=num_epochs, resume=True,
                               exp_dir=str(exp_dir)),
                          device="cpu", mesh=mesh)
        state, history = trainer.fit(fit_batches,
                                     state=trainer.init_state(scratch=False))
    finally:
        ckpt_lib.save_checkpoint = save
    return dict(_flat(state), epochs=np.asarray([h["epoch"] for h in history]),
                saves=np.asarray(saves, np.int64))


def run_dense(weights: dict, frames: Path, feat_path=None) -> dict:
    """``compute_visual_feats`` at its default ``mesh="auto"`` (the group
    where one is initialised), batch 4 over 13 frames: the last batch of 1
    leaves rank 1 only padding. The cache writes ride along."""
    writes = []
    save = tvf._save_feat_cache

    def counted(*args, **kwargs):
        writes.append(1)
        return save(*args, **kwargs)

    tvf._save_feat_cache = counted
    try:
        logits = tvf.compute_visual_feats(
            frame_imdb(frames), _teacher(weights, False, 0.0),
            {k: v.to(F64) for k, v in weights["teacher"].items()},
            feat_path=feat_path, batch_size=4,
            frame_root=str(frames), verbose=False, device="cpu")
    finally:
        tvf._save_feat_cache = save
    return {"logits": np.concatenate(logits),
            "writes": np.asarray(len(writes))}


def run_distill(data: Path, out_root: Path) -> dict:
    """``run_distillation`` (tiny bf16 student, offline, one epoch) at its
    default ``mesh="auto"``: the group's ranks where one is initialised."""
    from mcncrossmodalemotions_torch.data.imdb import EmoVoxImdb
    from mcncrossmodalemotions_torch.exp import run_distillation as rd

    cfg = rd.DistillationConfig(num_epochs=1, batch_size=4, num_seconds=1.0,
                                tiny_model=True, mini_epoch_ratio=1.0,
                                out_root=str(out_root))
    _, history, exp_dir = rd.run_distillation(
        cfg, EmoVoxImdb.load(data / "distill.npz"), device="cpu")
    train, val = history[0]["train"], history[0]["val"]
    return {"losses": np.asarray([train["loss"], val["loss"]]),
            "samples": np.asarray([train["num_samples"], val["num_samples"]]),
            "metas": np.asarray(len(list(exp_dir.glob("meta-*.json")))),
            "checkpoints": np.asarray(len(ckpt_lib.list_checkpoints(exp_dir)))}


def frame_imdb(frames: Path):
    from mcncrossmodalemotions_torch.data.imdb import TrackImdb

    names = sorted(p.name for p in frames.glob("*.jpg"))
    tracks = [np.asarray(names[i:i + 5], dtype=object)
              for i in range(0, len(names), 5)]
    n = len(tracks)
    return TrackImdb(track_ids=np.arange(n), labels=np.zeros(n, np.int32),
                     set_id=np.ones(n, np.int32), frame_paths=tracks)


# -- the worker -----------------------------------------------------------

def _worker(rank: int, world: int, port: int, out: Path, scenario: str,
            data: Path) -> None:
    faulthandler.dump_traceback_later(WORKER_TIMEOUT, exit=True)
    torch.set_num_threads(2)
    pmesh.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                               backend="gloo")
    mesh = pmesh.make_mesh(world, device="cpu")
    weights = torch.load(data / "weights.pt")
    if scenario == "steps":
        runs = {"bn": run_bn(mesh),
                "student": run_student(weights, mesh),
                "student_dropout": run_student(weights, mesh, 0.5),
                "online": run_online(weights, mesh),
                "teacher": run_teacher(weights, mesh)}
    else:
        runs = {"fit_a": run_fit(weights, data / "exp_a", 2, mesh),
                "fit_b": run_fit(weights, data / "exp_b", 3, mesh),
                "dense": run_dense(weights, data / "frames",
                                   str(data / "feats.npz")),
                "distill": run_distill(data, data / "distill")}
    np.savez(out, **{f"{run}/{k}": v for run, r in runs.items()
                     for k, v in r.items()})
    torch.distributed.destroy_process_group()


def _spawn(tmp_path: Path, scenario: str, data: Path) -> list:
    """Two ranks of ``scenario``; returns each rank's runs as
    {run: {key: array}}."""
    outs = [tmp_path / f"{scenario}{r}.npz" for r in range(2)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for attempt in range(3):
        with socket.socket() as s:  # bind-then-close: a race the retry covers
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, __file__, str(r), "2", str(port), str(outs[r]),
             scenario, str(data)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(2)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=WORKER_TIMEOUT + 30)[0]
                            .decode(errors="replace"))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail(f"{scenario} worker timed out")
        if all(p.returncode == 0 for p in procs):
            break
        bindish = any(k in log.lower() for log in logs
                      for k in ("address already in use", "bind",
                                "failed to connect"))
        if not bindish or attempt == 2:
            for p, log in zip(procs, logs):
                assert p.returncode == 0, f"rank failed:\n{log[-3000:]}"
    result = []
    for o in outs:
        with np.load(o) as z:
            runs: dict = {}
            for key in z.files:
                run, k = key.split("/", 1)
                runs.setdefault(run, {})[k] = z[key]
            result.append(runs)
    return result


def _same_ranks(ranks: list, run: str) -> None:
    a, b = ranks[0][run], ranks[1][run]
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=f"{run} {key}")


def _close(got: dict, ref: dict, run: str, tol: float = TOL,
           scaled: bool = False) -> None:
    """Float entries within ``tol`` (times each entry's largest magnitude
    with ``scaled``), the rest equal."""
    for key, want in ref.items():
        if want.dtype.kind == "f":
            atol = tol * np.abs(want).max() if scaled else tol
            np.testing.assert_allclose(got[key], want, rtol=0, atol=atol,
                                       err_msg=f"{run} {key}")
        else:
            np.testing.assert_array_equal(got[key], want,
                                          err_msg=f"{run} {key}")


# -- fixtures -------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Flax's scratch init of the tiny student, a seeded tiny SENet
    teacher, through the bridge; saved for the workers."""
    import jax
    import jax.numpy as jnp

    from mcncrossmodalemotions_torch.zoo import (
        random_teacher_variables,
        student_state_dict_from_flax,
        teacher_state_dict_from_flax,
    )
    from mcncrossmodalemotions_tpu.models.vggm import VGGMStudent as JaxVGGM

    data = student_batches()[0]["data"]
    flax = JaxVGGM(dtype=jnp.float32, **TINY_STUDENT).init(
        jax.random.PRNGKey(0), jnp.asarray(data[:1], jnp.float32))
    flax = jax.tree_util.tree_map(np.asarray, flax)
    t = random_teacher_variables(seed=7, **TINY_RESNET)
    w = {"student": student_state_dict_from_flax(flax),
         "teacher": {f"teacher.{k}": v for k, v in teacher_state_dict_from_flax(
             {"params": t["params"], "batch_stats": t["batch_stats"]}).items()},
         "flax": flax}
    root = tmp_path_factory.mktemp("parallel")
    torch.save({k: w[k] for k in ("student", "teacher")}, root / "weights.pt")
    w["root"] = root
    return w


# -- without extra processes ----------------------------------------------

def test_pad_to_multiple_equals_jax():
    from hypothesis import given, settings
    from hypothesis import strategies as st

    from mcncrossmodalemotions_tpu.parallel.mesh import (
        pad_to_multiple as jpad,
    )

    @settings(max_examples=200, deadline=None, database=None)
    @given(st.integers(1, 9), st.integers(1, 8), st.booleans(),
           st.lists(st.booleans(), min_size=9, max_size=9))
    def check(n, multiple, masked, bits):
        rng = np.random.RandomState(n)
        batch = {"data": rng.randn(n, 3).astype(np.float32),
                 "label": np.arange(n), "meta": "kept", "other": np.ones(2)}
        if masked:
            batch["pad_mask"] = np.float32(bits[:n])
        got, n_got = pmesh.pad_to_multiple(dict(batch), multiple)
        want, n_want = jpad(dict(batch), multiple)
        assert n_got == n_want
        assert sorted(got) == sorted(want)
        for k in want:
            if isinstance(want[k], np.ndarray):
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype
            else:
                assert got[k] == want[k]

    check()


def _fake_group(monkeypatch, world: int, rank: int = 0,
                backend: str = "gloo") -> None:
    monkeypatch.setattr(pmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pmesh.dist, "get_world_size", lambda *a: world)
    monkeypatch.setattr(pmesh.dist, "get_rank", lambda *a: rank)
    monkeypatch.setattr(pmesh.dist, "get_backend", lambda *a: backend)


def test_make_mesh_refuses_an_impossible_request(monkeypatch):
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        pmesh.make_mesh(device="cpu")  # no process group
    _fake_group(monkeypatch, world=2, rank=1)
    for asked in (4, 1):
        with pytest.raises(ValueError, match="has 2 rank"):
            pmesh.make_mesh(asked, device="cpu")
    mesh = pmesh.make_mesh(2, device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.device) == (1, 2,
                                                         torch.device("cpu"))
    _fake_group(monkeypatch, world=2, backend="nccl")
    with pytest.raises(ValueError, match="NCCL"):
        pmesh.make_mesh(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_mesh()  # the card by default: none here


def test_auto_mesh_rule(monkeypatch):
    assert pmesh.world_size() == 1 and pmesh.process_index() == 0
    assert pmesh.auto_mesh(64, device="cpu") is None  # one process
    _fake_group(monkeypatch, world=4, rank=3)
    mesh = pmesh.auto_mesh(64, device="cpu")
    assert (mesh.rank, mesh.world_size) == (3, 4)
    assert mesh.rows(64) == slice(48, 64)
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        pmesh.auto_mesh(66, device="cpu")  # JAX would shrink to 3 devices
    with pytest.raises(ValueError, match="pad it first"):
        mesh.rows(6)


def test_shard_batch_takes_the_rank_rows():
    batch = {"data": np.arange(12).reshape(6, 2), "label": np.arange(6),
             "pad_mask": torch.arange(6.0), "meta": np.zeros(3), "name": "x"}
    for rank in range(3):
        mesh = pmesh.DataMesh(rank, 3, torch.device("cpu"))
        got = pmesh.shard_batch(batch, mesh)
        np.testing.assert_array_equal(got["data"],
                                      batch["data"][2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(got["label"], [2 * rank, 2 * rank + 1])
        assert torch.equal(got["pad_mask"],
                           torch.tensor([2.0 * rank, 2.0 * rank + 1]))
        assert got["meta"] is batch["meta"] and got["name"] == "x"


def test_initialize_multihost_argument_plumbing(monkeypatch):
    calls = []
    monkeypatch.setattr(pmesh.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    pmesh.initialize_multihost(num_processes=1)  # one process: nothing
    assert calls == []
    with pytest.raises(ValueError, match="torchrun"):
        pmesh.initialize_multihost()  # nothing to join
    pmesh.initialize_multihost("10.0.0.1:1234", num_processes=4,
                               process_id=2, backend="gloo")
    assert calls == [dict(backend="gloo", init_method="tcp://10.0.0.1:1234",
                          world_size=4, rank=2)]
    calls.clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "host0")
    monkeypatch.setenv("MASTER_PORT", "29400")
    pmesh.initialize_multihost()  # torchrun's environment, gloo on the CPU
    assert calls == [dict(backend="gloo", init_method="tcp://host0:29400",
                          world_size=2, rank=1)]
    calls.clear()
    monkeypatch.setenv("WORLD_SIZE", "1")
    pmesh.initialize_multihost()
    assert calls == []


def test_cli_joins_the_group_under_torchrun(monkeypatch, tmp_path):
    """With ``WORLD_SIZE > 1`` (a torchrun rank) the CLI joins the process
    group before its command runs, over gloo with ``device=cpu``; one
    process joins nothing."""
    from mcncrossmodalemotions_torch import cli

    monkeypatch.setenv("MCN_TPU_ARTIFACT_ROOT", str(tmp_path))
    calls = []
    monkeypatch.setattr(pmesh, "initialize_multihost",
                        lambda **kw: calls.append(kw))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert cli.main(["fetch", "device=cpu"]) == 0
    assert calls == []
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert cli.main(["fetch", "device=cpu"]) == 0
    assert calls == [{"backend": "gloo"}]
    cli.main(["fetch"])
    assert calls[-1] == {"backend": None}


@pytest.mark.parametrize("world", [2, 3])
def test_draws_at_the_global_shape_are_one_process_draws(world):
    """Each rank draws the global batch's dropout mask and fliplr from its
    copy of the generator and keeps its rows: together they are the one
    process's draws, and every generator ends where the one process's
    does."""
    x = torch.randn(6, 5, dtype=F64)
    one = torch.Generator().manual_seed(3)
    want_drop = dropout(x, 0.5, one)
    want_flip = random_flip(6, 0.5, one)
    parts, flips, states = [], [], []
    for rank in range(world):
        mesh = pmesh.DataMesh(rank, world, torch.device("cpu"))
        gen = torch.Generator().manual_seed(3)
        parts.append(dropout(x[mesh.rows(6)], 0.5, gen, mesh))
        flips.append(random_flip(6 // world, 0.5, gen, mesh))
        states.append(gen.get_state())
    assert torch.equal(torch.cat(parts), want_drop)
    assert torch.equal(torch.cat(flips), want_flip)
    assert all(torch.equal(s, one.get_state()) for s in states)


# -- two ranks --------------------------------------------------------------

def _jax_student(weights: dict) -> dict:
    """The JAX package's Trainer under make_mesh(2), float64, the same 4
    batches; mapped to the port's names."""
    import jax
    import jax.numpy as jnp

    from mcncrossmodalemotions_torch.zoo import (
        student_params_from_flax,
        student_state_dict_from_flax,
    )
    from mcncrossmodalemotions_tpu.models.vggm import VGGMStudent as JaxVGGM
    from mcncrossmodalemotions_tpu.parallel.mesh import make_mesh
    from mcncrossmodalemotions_tpu.train import engine as jengine
    from mcncrossmodalemotions_tpu.train import state as jstate
    from mcncrossmodalemotions_tpu.zoo import student_loss_fn as jloss

    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        trainer = jengine.Trainer(
            JaxVGGM(dtype=jnp.float64, param_dtype=jnp.float64,
                    **TINY_STUDENT),
            jloss("hot-cross-ent", temperature=2.0),
            jengine.TrainConfig(learning_rate=LR, weight_decay=WD,
                                log_every=1000, resume=False),
            mesh=make_mesh(2))
        state = jstate.TrainState.create(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   weights["flax"]), jax.random.PRNGKey(1))
        losses = []
        for b in student_batches():
            state, stats = trainer.run_epoch(state, [b], epoch=1)
            losses.append(stats["loss"])
        tree = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            {"params": state.params, "velocity": state.velocity,
             "batch_stats": state.model_state["batch_stats"]})
    out = {f"model.{k}": v.numpy() for k, v in student_state_dict_from_flax(
        {"params": tree["params"],
         "batch_stats": tree["batch_stats"]}).items()}
    out.update({f"velocity.{k}": np.asarray(v) for k, v in
                student_params_from_flax(tree["velocity"]).items()})
    out["losses"] = np.asarray(losses)
    return out


def test_two_ranks_step_as_one_process(weights, tmp_path):
    ranks = _spawn(tmp_path, "steps", weights["root"])
    _same_ranks(ranks, "bn")
    bn = run_bn()
    _close(ranks[0]["bn"], bn, "bn")
    assert np.abs(bn["gx"][2:]).max() == 0  # padding rows get no gradient
    refs = {"student": run_student(weights),
            "student_dropout": run_student(weights, dropout_rate=0.5),
            "online": run_online(weights),
            "teacher": run_teacher(weights)}
    for run, ref in refs.items():
        _same_ranks(ranks, run)
        _close(ranks[0][run], ref, run, FP32_TOL, scaled=True)
        assert np.all(np.isfinite(ref["losses"]))
    got = ranks[0]["student"]
    assert int(got["step"]) == 4
    want = _jax_student(weights)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for key, ref in want.items():
        if key == "losses":
            continue
        np.testing.assert_allclose(got[key], ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=key)
    # dropout and fliplr drew something: the dropout run differs
    assert not np.allclose(ranks[0]["student_dropout"]["model.fc7.weight"],
                           refs["student"]["model.fc7.weight"])


def test_two_ranks_fit_resume_and_dense(weights, tmp_path):
    from mcncrossmodalemotions_torch.data import native_audio, native_faces
    from mcncrossmodalemotions_torch.data.emovox import build_synthetic_imdb
    from mcncrossmodalemotions_torch.data.images import save_synthetic_frame

    data = tmp_path / "data"
    data.mkdir()
    (data / "weights.pt").write_bytes((weights["root"] / "weights.pt")
                                      .read_bytes())
    for k in range(13):
        save_synthetic_frame(data / "frames" / f"{k:05d}.jpg", k % 7,
                             size=48 if k % 2 else 40, seed=k)
    build_synthetic_imdb(data / "wav", num_speakers=3, tracks_per_speaker=4,
                         duration_range=(1.2, 2.0)).save(data / "distill.npz")
    for lib in (native_faces, native_audio):
        lib.available()  # built here: the ranks do not race to build them
    run_fit(weights, data / "exp_b", 2)  # one process; the ranks resume it
    ranks = _spawn(tmp_path, "fit", data)
    ref = run_fit(weights, tmp_path / "ref", 3)
    resumed = run_fit(weights, data / "exp_a", 3)  # the ranks' 2 epochs
    for run in ("fit_a", "fit_b", "dense"):
        _same_ranks([{run: {k: v for k, v in r[run].items()
                            if k not in ("saves", "writes")}} for r in ranks],
                    run)
    assert list(ranks[0]["fit_a"]["epochs"]) == [1, 2]
    assert list(ranks[0]["fit_b"]["epochs"]) == [3]
    assert list(resumed["epochs"]) == [3]
    # rank 0 alone saved; both ranks resumed the other side's checkpoints
    assert list(ranks[0]["fit_a"]["saves"]) == [1, 2]
    assert list(ranks[0]["fit_b"]["saves"]) == [3]
    assert ranks[1]["fit_a"]["saves"].size == ranks[1]["fit_b"]["saves"].size == 0
    for exp in ("exp_a", "exp_b"):
        lines = (data / exp / "metrics.jsonl").read_text().splitlines()
        assert [json.loads(l)["epoch"] for l in lines] == [1, 2, 3]
    drop = ("epochs", "saves")
    ref = {k: v for k, v in ref.items() if k not in drop}
    _close(resumed, ref, "2 ranks then 1", FP32_TOL, scaled=True)
    _close(ranks[0]["fit_b"], ref, "1 then 2 ranks", FP32_TOL, scaled=True)
    dense = run_dense(weights, data / "frames")
    assert dense["logits"].shape == (13, 8)
    _close(ranks[0]["dense"], {"logits": dense["logits"]}, "dense",
           FP32_TOL, scaled=True)
    assert int(ranks[0]["dense"]["writes"]) == 1
    assert int(ranks[1]["dense"]["writes"]) == 0
    cached = tvf._load_feat_cache(str(data / "feats.npz"), 3,
                                  "senet50-ferplus")
    np.testing.assert_array_equal(np.concatenate(cached),
                                  ranks[1]["dense"]["logits"])
    # run_distillation under the group: one meta dump and checkpoint (rank
    # 0's), the global counts, and one process's losses within the bf16
    # student's spread (chip_smoke's 1e-2 train gate)
    _same_ranks(ranks, "distill")
    got, one = ranks[0]["distill"], run_distill(data, tmp_path / "one")
    assert int(got["metas"]) == int(got["checkpoints"]) == 1
    np.testing.assert_array_equal(got["samples"], one["samples"])
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-2)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            Path(sys.argv[4]), sys.argv[5], Path(sys.argv[6]))
