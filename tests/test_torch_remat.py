"""The student's remat policies on the CPU.

A remat policy recomputes activations in the backward instead of keeping
them; the same operations run again, so the state after three SGD steps
must be bitwise the state without a policy (float64, dropout 0.5, a ragged
``pad_mask``, weight decay and a changing lr), for each of the five
policies of the JAX package (``drop_conv1``, ``drop_through_pool1``,
``save_pools``, ``dots``, ``nothing``), in the plain step and in the fused
online step (a checkpointed run and a selective one). Also:

- BatchNorm's running statistics are updated once a step whatever the
  policy recomputes (each BatchNorm updated once, recomputes with the
  update off);
- the recomputes happen: pool1/pool2's with-index forward runs 2 + the
  policy's recomputed pools a step (on the card, K2 with-index launches
  per step: none 2, drop_conv1 2, drop_through_pool1 3, save_pools 4,
  dots 4, nothing 4; K2 backward 2 and K1 1 for all), and the convs again;
- a policy needs a model with remat stages (the students), an unknown
  name raises, and ``Trainer`` refuses a policy beside a step override.
"""

import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.models import vggm
from mcncrossmodalemotions_torch.models.teacher_pipeline import (
    FaceTeacherPipeline,
)
from mcncrossmodalemotions_torch.ops import pool
from mcncrossmodalemotions_torch.train import distill, engine
from mcncrossmodalemotions_torch.train import state as tstate
from mcncrossmodalemotions_torch.zoo import (
    build_student,
    build_teacher,
    student_loss_fn,
)

POLICIES = ["drop_conv1", "drop_through_pool1", "save_pools", "dots",
            "nothing"]
LRS = (1e-2, 5e-3, 2e-3)
# with-index pool forwards a step: 2 in the forward + the recomputed ones
POOL_RUNS = {None: 2, "drop_conv1": 2, "drop_through_pool1": 3,
             "save_pools": 4, "dots": 4, "nothing": 4}
CONV_RUNS = {None: 6, "drop_conv1": 7, "drop_through_pool1": 8,
             "save_pools": 12, "dots": 12, "nothing": 12}
BN_RECOMPUTES = {None: 0, "drop_conv1": 1, "drop_through_pool1": 1,
                 "save_pools": 6, "dots": 6, "nothing": 6}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    gen = torch.Generator().manual_seed(1)
    frames = torch.randint(0, 256, (4, 2, 48, 48, 1), generator=gen,
                           dtype=torch.uint8)
    return {"data": (torch.randn(4, 16384, generator=gen) * 3000).to(torch.int16),
            "logit_target": torch.randn(4, 8, generator=gen,
                                        dtype=torch.float64) * 2,
            "max_label": torch.tensor([1, 5, 2, 7], dtype=torch.int32),
            "pad_mask": torch.tensor([1.0, 1.0, 0.0, 1.0], dtype=torch.float64),
            "frames": frames}


def _state(dropout=0.5):
    model = build_student(tiny=True, dropout=dropout, dtype=torch.float64,
                          generator=torch.Generator().manual_seed(0))
    return tstate.TrainState.create(model.double(),
                                    torch.Generator().manual_seed(3))


def _teacher():
    teacher = FaceTeacherPipeline(
        build_teacher("senet50-ferplus", tiny=True), input_size=48,
        augment=False)
    teacher.reset_parameters(torch.Generator().manual_seed(2))
    teacher.teacher.dtype = torch.float64
    return teacher.double()


def _run(step, batch, dropout=0.5):
    state = _state(dropout)
    losses = []
    for lr in LRS:
        state, m = step(state, batch, lr)
        losses.append(m["loss"].item())
    return state, losses


def _assert_same(a, b):
    (sa, la), (sb, lb) = a, b
    assert la == lb
    for k, v in sb.model.state_dict().items():
        assert torch.equal(sa.model.state_dict()[k], v), k
    for k, v in sb.velocity.items():
        assert torch.equal(sa.velocity[k], v), k
    assert torch.equal(sa.generator.get_state(), sb.generator.get_state())


@pytest.fixture(scope="module")
def plain_runs(batch):
    loss = student_loss_fn("hot-cross-ent", temperature=2.0)
    sgd = tstate.SGDConfig(weight_decay=5e-4)
    fused = distill.make_online_distill_step(_teacher(), sgd=sgd)
    return {"step": _run(tstate.make_train_step(loss, sgd, pass_pad_mask=True),
                         batch),
            "fused": _run(fused, batch)}


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_state_bitwise_equal_to_no_policy(batch, plain_runs, policy):
    step = tstate.make_train_step(student_loss_fn("hot-cross-ent",
                                                  temperature=2.0),
                                  tstate.SGDConfig(weight_decay=5e-4),
                                  remat_policy=policy, pass_pad_mask=True)
    got = _run(step, batch)
    _assert_same(got, plain_runs["step"])
    assert len(set(got[1])) == 3  # every step moved the weights


@pytest.mark.parametrize("policy", ["drop_through_pool1", "dots"])
def test_fused_step_with_a_policy_equals_without(batch, plain_runs, policy):
    step = distill.make_online_distill_step(
        _teacher(), sgd=tstate.SGDConfig(weight_decay=5e-4),
        remat_policy=policy)
    _assert_same(_run(step, batch), plain_runs["fused"])


@pytest.mark.parametrize("policy", [None] + POLICIES)
def test_running_statistics_updated_once_and_recomputes_counted(
        batch, monkeypatch, policy):
    calls = {"update": 0, "recompute": 0, "pool": 0, "conv": 0}
    bn_train, with_index = vggm.batch_norm_train, pool.max_pool_3x3s2_with_index
    conv2d = vggm.F.conv2d

    def counted_bn(x, bn, pad_mask=None, update=True, mesh=None, relu=False,
                   use_kernels=True):
        calls["update" if update else "recompute"] += 1
        return bn_train(x, bn, pad_mask, update, mesh, relu=relu,
                        use_kernels=use_kernels)

    def counted_pool(x):
        calls["pool"] += 1
        return with_index(x)

    def counted_conv(*args, **kwargs):
        calls["conv"] += 1
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(vggm, "batch_norm_train", counted_bn)
    monkeypatch.setattr(pool, "max_pool_3x3s2_with_index", counted_pool)
    monkeypatch.setattr(vggm.F, "conv2d", counted_conv)
    state = _state(dropout=0.0)
    before = {k: v.clone() for k, v in state.model.state_dict().items()
              if "running" in k}
    step = tstate.make_train_step(student_loss_fn(), remat_policy=policy,
                                  pass_pad_mask=True)
    state, _ = step(state, batch, 1e-2)
    assert calls["update"] == 6  # six BatchNorms, each updated once
    assert calls["recompute"] == BN_RECOMPUTES[policy]
    assert calls["pool"] == POOL_RUNS[policy]
    assert calls["conv"] == CONV_RUNS[policy]
    for k, v in before.items():
        assert not torch.equal(state.model.state_dict()[k], v), k


def test_policy_names_and_refusals():
    assert tstate.resolve_remat_policy(None) is None
    assert tstate.resolve_remat_policy("none") is None
    for name in POLICIES:
        assert tstate.resolve_remat_policy(name) == name
    assert sorted(vggm.REMAT_RUNS) == sorted(POLICIES)
    with pytest.raises(ValueError, match="unknown remat policy"):
        tstate.make_train_step(student_loss_fn(), remat_policy="everything")
    teacher = FaceTeacherPipeline(build_teacher("senet50-ferplus", tiny=True),
                                  input_size=48, augment=False)
    state = tstate.TrainState.create(teacher, torch.Generator().manual_seed(0))
    step = tstate.make_train_step(student_loss_fn(), remat_policy="nothing")
    with pytest.raises(ValueError, match="no remat stages"):
        step(state, {"data": torch.zeros(2, 48, 48, 1, dtype=torch.uint8),
                     "logit_target": torch.zeros(2, 8),
                     "max_label": torch.zeros(2, dtype=torch.int32)}, 1e-2)
    cfg = engine.TrainConfig(remat_policy="dots")
    with pytest.raises(ValueError, match="override's builder"):
        engine.Trainer(build_student(tiny=True), student_loss_fn(), cfg,
                       device="cpu", train_step_override=lambda *a: a)
    with pytest.raises(ValueError, match="lr_scale_fn"):
        engine.Trainer(build_student(tiny=True), student_loss_fn(),
                       engine.TrainConfig(), device="cpu",
                       lr_scale_fn=tstate.finetune_lr_scale_fn(),
                       train_step_override=lambda *a: a)


def test_eval_forward_ignores_the_policy():
    model = build_student(tiny=True, with_frontend=False, dtype=torch.float32)
    x = torch.randn(2, 512, 100, 1, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(x)
        got = model(x, remat_policy="nothing")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
