"""The trainer's remaining flags of the JAX CLI (``recnext_tpu/train/main.py:129-165``)
on the CPU at a small size: ``--ckpt-every-steps`` then ``--resume`` (the step count
and the next losses those of an uninterrupted run; a mid-epoch recovery replays its
epoch from batch 0), ``--eval-ema`` (the EMA weights scored alone),
``--export-teacher`` read back strictly by ``--teacher-ckpt``, ``--wandb`` without
wandb, ``--fsdp 2`` refused."""

import json

import numpy as np
import pytest
import torch

from recnext_tpu_torch.models import registry
from recnext_tpu_torch.train import main as tmain

SMALL = "embed_dim=16:32:64:128,depth=1:1:2:1"
TINY_M = "recnext_m_tiny_test"


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _train(out, *extra, epochs=2, model=("--model", "recnext_m0", "--model-kwargs", SMALL)):
    return tmain.main(["--device", "cpu", *model, "--data-set", "FAKE", "--simple-aug",
                       "--input-size", "32", "--batch-size", "4", "--epochs", str(epochs),
                       "--steps-per-epoch", "2", "--fake-classes", "11", "--dtype", "float32",
                       "--log-every", "1", "--warmup-epochs", "1", "--output-dir", str(out),
                       *extra])


def _losses(text):
    return [line for line in text.splitlines() if ": loss " in line]


def _stats(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """Two epochs of two steps in one run: its log and final state."""
    import contextlib
    import io

    torch.set_num_threads(1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = _train(tmp_path_factory.mktemp("full"))
    return buf.getvalue(), res["state"]


def test_recovery_then_resume_continues_the_uninterrupted_run(uninterrupted, tmp_path, capsys):
    text, state = uninterrupted
    # epoch 0 with a recovery checkpoint every 2 steps: the last is the epoch's end
    _train(tmp_path / "a", "--ckpt-every-steps", "2", epochs=1)
    out = capsys.readouterr().out
    assert "recovery checkpoint at epoch 0 step 2" in out
    assert _losses(out) == _losses(text)[:2]
    recovery = tmp_path / "a" / "recovery.pt"
    assert torch.load(recovery, weights_only=True)["state"]["step"] == 2
    assert not list((tmp_path / "a").glob(".*.tmp"))  # written atomically
    # a fresh output directory, resumed from it: epoch 1 as the uninterrupted run ran it
    res = _train(tmp_path / "b", "--resume", str(recovery))
    out = capsys.readouterr().out
    assert f"resumed from {recovery} at epoch 1" in out
    assert _losses(out) == _losses(text)[2:]
    assert [s["epoch"] for s in _stats(out)] == [1]
    assert res["state"].step == state.step == 4
    assert all(torch.equal(v, state.model.state_dict()[k])
               for k, v in res["state"].model.state_dict().items())


def test_a_mid_epoch_recovery_replays_its_epoch_from_batch_0(tmp_path, capsys):
    _train(tmp_path / "a", "--ckpt-every-steps", "1", epochs=1)
    first = _losses(capsys.readouterr().out)
    # the last recovery checkpoint is step 2's; one written at step 1 is mid-epoch
    state = torch.load(tmp_path / "a" / "recovery.pt", weights_only=True)
    state["state"]["step"] = 1
    torch.save(state, tmp_path / "mid.pt")
    res = _train(tmp_path / "b", "--resume", str(tmp_path / "mid.pt"), epochs=1)
    out = capsys.readouterr().out
    assert "at epoch 0" in out and len(_losses(out)) == 2
    assert _losses(out)[0].split(":")[0] == first[0].split(":")[0]  # batch 0 again
    assert res["state"].step == 3


def test_eval_ema_scores_the_ema_weights_alone(uninterrupted, tmp_path, capsys):
    text, _ = uninterrupted
    _train(tmp_path, "--eval-ema")
    got, want = _stats(capsys.readouterr().out), _stats(text)
    for g, w in zip(got, want):
        assert "ema_test_acc1" not in g and "ema_test_acc1" in w
        assert g["test_acc1"] == w["ema_test_acc1"] and g["test_acc5"] == w["ema_test_acc5"]
        assert g["train_loss"] == w["train_loss"]


@pytest.mark.parametrize("ema", [True, False])
def test_export_teacher_is_read_back_by_teacher_ckpt(tmp_path, capsys, monkeypatch, ema):
    base = registry.MODEL_CONFIGS["recnext_m0"]
    monkeypatch.setitem(registry.MODEL_CONFIGS, TINY_M, type(base)(**{
        **base.__dict__, "name": TINY_M, "embed_dim": (16, 32, 64, 128),
        "depth": (1, 1, 2, 1)}))
    teacher = tmp_path / "teacher" / "t.pt"
    res = _train(tmp_path / "a", "--export-teacher", str(teacher),
                 *(() if ema else ("--no-model-ema",)), epochs=1, model=("--model", TINY_M))
    out = capsys.readouterr().out
    assert f"exported {'EMA ' if ema else ''}teacher weights to {teacher}" in out
    saved = torch.load(teacher, weights_only=True)
    want = res["state"].variables(ema=ema)
    assert set(saved) == set(want) and all(torch.equal(saved[k], want[k]) for k in want)
    _train(tmp_path / "b", "--distillation-type", "hard", "--teacher-model", TINY_M,
           "--teacher-ckpt", str(teacher), epochs=1,
           model=("--model", "recnext_a0", "--model-kwargs", SMALL))
    out = capsys.readouterr().out
    assert f"teacher {TINY_M}: " in out and str(teacher) in out
    assert all(np.isfinite(s["train_loss"]) for s in _stats(out))


def test_wandb_without_wandb_logs_a_line(tmp_path, capsys, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_wandb(name, *args, **kwargs):
        if name == "wandb":
            raise ImportError("no wandb here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_wandb)
    _train(tmp_path, "--wandb", epochs=1)
    out = capsys.readouterr().out
    assert "wandb requested but unavailable; continuing without it" in out
    assert len(_stats(out)) == 1


def test_fsdp_above_1_raises_naming_its_item(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 17"):
        _train(tmp_path, "--fsdp", "2", epochs=1)
    res = _train(tmp_path, "--fsdp", "1", epochs=1)  # 1 is the default, and trains
    assert res["state"].step == 2
