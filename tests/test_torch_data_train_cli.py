"""The port's FAKE data set, simple train transform and loaders against the JAX
package's (indices and pixels, NHWC -> NCHW), the training CLI on the CPU (two
epochs, a checkpoint, auto-resume; hard distillation from a teacher and its
checkpoint; the full train transform; a class folder) and the bench's train and
loader modes on the CPU, with and without a teacher."""

import json

import numpy as np
import pytest
import torch

from recnext_tpu.data import datasets as jds
from recnext_tpu.data import loader as jloader
from recnext_tpu.data import transforms as jtf
from recnext_tpu_torch import bench
from recnext_tpu_torch.data import datasets as tds
from recnext_tpu_torch.data import loader as tloader
from recnext_tpu_torch.data import transforms as ttf
from recnext_tpu_torch.models import regnet as tregnet
from recnext_tpu_torch.models.registry import create_model
from recnext_tpu_torch.train import main as tmain
from recnext_tpu_torch.train.finetune import read_weights

SMALL = "embed_dim=16:32:64:128,depth=1:1:2:1"


@pytest.fixture(autouse=True)
def one_thread():
    """Small models on one thread: the suite runs several test processes at once,
    and torch's default of a thread per core would oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_fake_data_matches_jax():
    jd, jn = jds.build_dataset(True, "FAKE", "", 24, 7)
    td, tn = tds.build_dataset(True, "FAKE", "", 24, 7)
    assert (len(td), tn) == (len(jd), jn) == (2048, 7)
    assert len(tds.build_dataset(False, "FAKE", "", 24, 7)[0]) == 512
    for i in (0, 5, 2047):
        (ji, jl), (ti, tl) = jd[i], td[i]
        assert jl == tl
        np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))


def test_other_data_sets_raise_naming_the_item(tmp_path):
    """IMNET (once a raise naming the data pipeline's item) reads <path>/train as the
    JAX package does; an unknown data set raises naming it."""
    bench.make_folder(tmp_path / "train", 6, classes=2, w=40, h=30)
    (td, tn), (jd, jn) = (tds.build_dataset(True, "IMNET", str(tmp_path)),
                          jds.build_dataset(True, "IMNET", str(tmp_path)))
    assert (tn, len(td), td.samples[3][1]) == (jn, len(jd), jd.samples[3][1]) == (1000, 6, 1)
    np.testing.assert_array_equal(np.asarray(td[3][0]), np.asarray(jd[3][0]))
    with pytest.raises(ValueError, match="'SVHN'"):
        tds.build_dataset(True, "SVHN", str(tmp_path))


def test_simple_train_transform_matches_jax():
    img = jds.FakeData(4, 40, 3)[1][0]
    for seed in range(4):
        want = jtf.SimpleTrainTransform(24)(np.random.default_rng(seed), img)
        got = ttf.SimpleTrainTransform(24)(np.random.default_rng(seed), img)
        assert got.shape == (3, 24, 24) and got.dtype == np.float32
        np.testing.assert_array_equal(got.transpose(1, 2, 0), want)
    rng = np.random.default_rng(0)
    assert ttf.rrc_rect(rng, 50, 30, (0.6, 1.0)) == jtf.rrc_rect(
        np.random.default_rng(0), 50, 30, (0.6, 1.0))


def test_train_loader_matches_jax_for_two_epochs():
    ds = jds.FakeData(24, 20, 5)
    for epoch in (0, 1):
        jb = list(jloader.train_loader(ds, jtf.SimpleTrainTransform(16), batch_size=4,
                                       epoch=epoch, repeated_aug=False, seed=3))
        tb = list(tloader.train_loader(tds.FakeData(24, 20, 5), ttf.SimpleTrainTransform(16),
                                       batch_size=4, epoch=epoch, repeated_aug=False, seed=3))
        assert len(tb) == len(jb) == 6
        for j, t in zip(jb, tb):
            assert t["image"].dtype == torch.float32 and t["label"].dtype == torch.int64
            np.testing.assert_array_equal(t["label"].numpy(), j["label"])
            np.testing.assert_array_equal(t["image"].numpy().transpose(0, 2, 3, 1), j["image"])
        # the repeated-augmentation sampler (the default of both): 3 copies of each index
        jb = list(jloader.train_loader(ds, jtf.SimpleTrainTransform(16), batch_size=4,
                                       epoch=epoch, seed=3))
        tb = list(tloader.train_loader(tds.FakeData(24, 20, 5), ttf.SimpleTrainTransform(16),
                                       batch_size=4, epoch=epoch, seed=3))
        assert len(tb) == len(jb) == 18
        for j, t in zip(jb, tb):
            np.testing.assert_array_equal(t["label"].numpy(), j["label"])
            np.testing.assert_array_equal(t["image"].numpy().transpose(0, 2, 3, 1), j["image"])


def test_eval_loader_matches_jax():
    ds = jds.FakeData(10, 40, 5)
    jb = list(jloader.eval_loader(ds, jtf.EvalTransform(32), batch_size=4))
    tb = list(tloader.eval_loader(tds.FakeData(10, 40, 5), ttf.EvalTransform(32), batch_size=4))
    assert [len(b["label"]) for b in tb] == [len(b["label"]) for b in jb] == [4, 4, 2]
    for j, t in zip(jb, tb):
        np.testing.assert_array_equal(t["label"].numpy(), j["label"])
        np.testing.assert_allclose(t["image"].numpy().transpose(0, 2, 3, 1), j["image"],
                                   rtol=0, atol=1e-6)


def test_loader_raises_a_pipeline_failure():
    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            raise OSError("corrupt sample")

    with pytest.raises(RuntimeError, match="input pipeline"):
        list(tloader.train_loader(Broken(), ttf.SimpleTrainTransform(8), batch_size=2,
                                  epoch=0))


def _cli(tmp_path, epochs, capsys):
    tmain.main(["--device", "cpu", "--model", "recnext_m0", "--model-kwargs", SMALL,
                "--data-set", "FAKE", "--simple-aug", "--input-size", "32", "--batch-size", "4",
                "--epochs", str(epochs), "--steps-per-epoch", "2", "--fake-classes", "11",
                "--dtype", "float32", "--log-every", "1", "--output-dir", str(tmp_path)])
    return capsys.readouterr().out


def test_train_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    out = _cli(tmp_path, 2, capsys)
    stats = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert [s["epoch"] for s in stats] == [0, 1]
    for s in stats:  # the JAX CLI's key names
        assert {"train_lr", "train_loss", "test_loss", "test_acc1", "test_acc5", "epoch",
                "n_parameters", "ema_test_acc1", "ema_test_acc5"} <= set(s)
        assert np.isfinite(s["train_loss"]) and np.isfinite(s["test_loss"])
    losses = [float(line.rsplit(" ", 1)[1]) for line in out.splitlines() if ": loss " in line]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("*.pt")) == [
        "epoch_0000.pt", "epoch_0001.pt"]
    assert len((tmp_path / "log.txt").read_text().splitlines()) == 2
    out = _cli(tmp_path, 3, capsys)
    assert "auto-resumed at epoch 2" in out
    assert [json.loads(line)["epoch"] for line in out.splitlines()
            if line.startswith("{")] == [2]
    saved = torch.load(tmp_path / "ckpt" / "epoch_0002.pt", weights_only=True)
    assert saved["state"]["step"] == 6 and saved["state"]["optimizer"]["count"] == 6
    # --eval scores the newest checkpoint and trains nothing
    tmain.main(["--device", "cpu", "--model", "recnext_m0", "--model-kwargs", SMALL,
                "--data-set", "FAKE", "--simple-aug", "--input-size", "32", "--batch-size", "4",
                "--steps-per-epoch", "2", "--fake-classes", "11", "--dtype", "float32",
                "--output-dir", str(tmp_path), "--eval"])
    out = capsys.readouterr().out
    assert "auto-resumed at epoch 3" in out
    rec = json.loads(out.strip().splitlines()[-1])
    assert set(rec) == {"test_loss", "test_acc1", "test_acc5"} and np.isfinite(rec["test_loss"])


def test_checkpoints_keep_the_last_three_and_the_best(tmp_path):
    ckpts = tmain.Checkpoints(tmp_path)
    for epoch, acc in enumerate([1.0, 9.0, 2.0, 3.0, 4.0]):
        ckpts.save(epoch, {"epoch": epoch}, acc)
    assert ckpts.epochs() == [1, 2, 3, 4] and ckpts.latest() == 4
    # a new manager reads the accuracies back: the best survives later saves
    again = tmain.Checkpoints(tmp_path)
    again.save(5, {"epoch": 5}, 0.5)
    assert again.epochs() == [1, 3, 4, 5]


def test_train_cli_refuses_what_is_not_ported(tmp_path, capsys):
    """What the trainer once refused (the full train transform; every data set but
    FAKE) now trains; a data set missing from --data-path still raises."""
    base = ["--device", "cpu", "--model", "recnext_m0", "--model-kwargs", SMALL,
            "--input-size", "32", "--batch-size", "4", "--epochs", "1", "--steps-per-epoch",
            "1", "--dtype", "float32"]
    tmain.main(base + ["--data-set", "FAKE", "--fake-classes", "11", "--output-dir",
                       str(tmp_path / "full")])  # the full train transform
    for split in ("train", "val"):
        bench.make_folder(tmp_path / "imnet" / split, 8, classes=2, w=40, h=30)
    res = tmain.main(base + ["--data-set", "IMNET", "--data-path", str(tmp_path / "imnet"),
                             "--simple-aug", "--output-dir", str(tmp_path / "imnet_run")])
    stats = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(stats) == 2 and all(np.isfinite(s["train_loss"]) for s in stats)
    assert res["state"].model.cfg.num_classes == 1000  # IMNET's classes
    with pytest.raises(FileNotFoundError):
        tmain.main(base + ["--data-set", "IMNET", "--data-path", str(tmp_path / "none"),
                           "--output-dir", str(tmp_path / "missing")])


def test_bench_train_mode_on_the_cpu(capsys):
    ips, batch, spread = bench.train_throughput(
        "recnext_m0", 4, device="cpu", timed_s=0.05, image_size=32, repeats=3,
        embed_dim=(16, 32, 64, 128), depth=(1, 1, 2, 1), num_classes=11)
    assert batch == 4 and ips > 0 and spread["min"] <= ips <= spread["max"]
    assert len(spread["runs"]) == 3
    rec = bench.main(["--train", "--device", "cpu", "--model", "recnext_m0",
                      "--model-kwargs", SMALL + ",num_classes=11", "--batch", "4",
                      "--image-size", "32", "--timed", "0.05", "--repeats", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    assert rec["metric"] == "recnext_m0_train_bf16_32_images_per_sec" and rec["device"] == "cpu"
    assert {"value", "unit", "vs_baseline", "spread", "step_ms"} <= set(rec)


def test_bench_loader_mode_on_the_cpu(capsys):
    """Every pipeline at workers 0 and 1, a rate each, with the host's CPU count."""
    recs = bench.main(["--loader", "--device", "cpu", "--images", "12", "--batch", "4",
                       "--workers", "1", "--image-size", "32"])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert lines == recs and len(recs) == 8
    assert [(r["pipeline"], r["workers"]) for r in recs] == [
        (p, w) for p in bench.LOADER_PIPELINES for w in (0, 1)]
    for r in recs:
        assert r["value"] > 0 and r["cpu_count"] >= 1 and r["affinity"] >= 1
        assert r["route"] == ("native" if r["pipeline"].startswith("native") else "pil")
        assert r["native_fallback_batches"] == 0 and r["images"] == 12 and r["batch"] == 4


def test_bench_default_and_latency_modes_on_the_cpu(capsys):
    rec = bench.main(["--device", "cpu", "--model", "recnext_m0", "--model-kwargs", SMALL,
                      "--batch", "2", "--image-size", "32", "--timed", "0.05", "--warmup", "0"])
    assert rec["metric"] == "recnext_m0_fused_bf16_32_images_per_sec" and rec["value"] > 0
    assert rec["vs_baseline"] is None  # baselines are at 224^2
    rec = bench.main(["--latency", "--latency-iters", "3", "--device", "cpu", "--model",
                      "recnext_m0", "--model-kwargs", SMALL, "--image-size", "32"])
    assert rec["unit"] == "ms" and rec["value"] > 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


def test_train_cli_runs_the_a_family_on_the_cpu(tmp_path, capsys):
    """The A family trains on the CPU through autograd over its plain ops (on the
    GPU, through its attention kernel and that kernel's backward)."""
    tmain.main(["--device", "cpu", "--model", "recnext_a0", "--model-kwargs", SMALL,
                "--data-set", "FAKE", "--simple-aug", "--input-size", "32", "--batch-size", "4",
                "--epochs", "1", "--steps-per-epoch", "2", "--fake-classes", "11",
                "--dtype", "float32", "--output-dir", str(tmp_path)])
    stats = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(stats) == 1 and np.isfinite(stats[0]["train_loss"])


TINY_TEACHER = "regnety_tiny_test"


@pytest.fixture
def tiny_teacher(monkeypatch):
    """A tiny RegNetY (tests/test_regnet.py:116's widths) under a registry name."""
    monkeypatch.setitem(tregnet.REGNET_CONFIGS, TINY_TEACHER, tregnet.RegNetConfig(
        TINY_TEACHER, w0=24, wa=24.0, wm=2.0, depth=4, group_width=8, stem_width=16))
    return TINY_TEACHER


def _distill_cli(tmp_path, epochs, *extra):
    return tmain.main(["--device", "cpu", "--model", "recnext_a0", "--model-kwargs", SMALL,
                       "--data-set", "FAKE", "--simple-aug", "--input-size", "32",
                       "--batch-size", "4", "--epochs", str(epochs), "--steps-per-epoch", "2",
                       "--fake-classes", "11", "--dtype", "float32", "--log-every", "1",
                       "--distillation-type", "hard", "--output-dir", str(tmp_path), *extra])


def test_train_cli_distills_from_a_teacher_and_resumes(tmp_path, capsys, tiny_teacher):
    res = _distill_cli(tmp_path, 2, "--teacher-model", tiny_teacher)
    out = capsys.readouterr().out
    assert f"teacher {tiny_teacher}:" in out and "seeded weights" in out
    stats = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert [s["epoch"] for s in stats] == [0, 1]
    assert all(np.isfinite(s["train_loss"]) for s in stats)
    assert res["state"].model.cfg.distillation  # the dual-head student
    _distill_cli(tmp_path, 3, "--teacher-model", tiny_teacher)
    out = capsys.readouterr().out
    assert "auto-resumed at epoch 2" in out
    assert [json.loads(line)["epoch"] for line in out.splitlines()
            if line.startswith("{")] == [2]


def test_train_cli_loads_the_teacher_checkpoint_strictly(tmp_path, capsys, tiny_teacher):
    teacher = tregnet.create_regnet(tiny_teacher, num_classes=11, device="cpu",
                                    generator=torch.Generator().manual_seed(9))
    ckpt = tmp_path / "teacher.pth"
    torch.save({"model": teacher.state_dict()}, ckpt)  # the timm checkpoint's wrapping
    _distill_cli(tmp_path / "run", 1, "--teacher-model", tiny_teacher,
                 "--teacher-ckpt", str(ckpt))
    assert f"teacher {tiny_teacher}: " in capsys.readouterr().out
    loaded = read_weights(str(ckpt), ema=False)
    assert all(torch.equal(loaded[k], v) for k, v in teacher.state_dict().items())
    # a registry model in the port's own layout: as saved, and in this trainer's checkpoint
    reg = create_model("recnext_m0", device="cpu", num_classes=11,
                       embed_dim=(16, 32, 64, 128), depth=(1, 1, 2, 1))
    torch.save(reg.state_dict(), tmp_path / "m0.pt")
    torch.save({"epoch": 0, "state": {"step": 2, "model": reg.state_dict()}},
               tmp_path / "epoch_0000.pt")
    for name in ("m0.pt", "epoch_0000.pt"):
        loaded = read_weights(str(tmp_path / name), ema=False)
        assert all(torch.equal(loaded[k], v) for k, v in reg.state_dict().items())
    # strict: a checkpoint that lacks a key is refused
    bad = {k: v for k, v in teacher.state_dict().items() if k != "head.fc.bias"}
    torch.save(bad, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="head.fc.bias"):
        _distill_cli(tmp_path / "run2", 1, "--teacher-model", tiny_teacher,
                     "--teacher-ckpt", str(tmp_path / "bad.pth"))


def test_train_cli_refuses_a_teacher_it_cannot_read(tmp_path, tiny_teacher):
    for ckpt in ("teacher.msgpack", "orbax_dir"):
        with pytest.raises(NotImplementedError, match="item 9"):
            _distill_cli(tmp_path, 1, "--teacher-model", tiny_teacher,
                         "--teacher-ckpt", str(tmp_path / ckpt))
    with pytest.raises(SystemExit, match="requires --teacher-model"):
        _distill_cli(tmp_path, 1)


def test_bench_train_mode_with_a_teacher_on_the_cpu(capsys, tiny_teacher):
    ips, batch, spread = bench.train_throughput(
        "recnext_a0", 4, device="cpu", timed_s=0.05, image_size=32, repeats=2,
        teacher=tiny_teacher, distillation="soft", embed_dim=(16, 32, 64, 128),
        depth=(1, 1, 2, 1), num_classes=11)
    assert batch == 4 and ips > 0 and len(spread["runs"]) == 2
    rec = bench.main(["--train", "--device", "cpu", "--model", "recnext_a0",
                      "--model-kwargs", SMALL + ",num_classes=11", "--batch", "4",
                      "--image-size", "32", "--timed", "0.05", "--repeats", "1",
                      "--teacher", tiny_teacher])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["teacher"] == tiny_teacher and rec["distillation"] == "hard" and rec["value"] > 0
