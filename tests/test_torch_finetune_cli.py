"""The trainer's finetune recipe and the validation CLI on the CPU, at small sizes:
``--finetune`` from the trainer's checkpoint and from a fused archive onto a head of
another class count, with ``--grad-accum 2 --remat --mesa 1.0``; ``validate.py`` on
FAKE data from each checkpoint format, its CSV row read back, its scores held
against the JAX package's ``validate.py`` on the same ``.pth``; and what both CLIs
refuse."""

import csv
import json

import numpy as np
import pytest
import torch

from recnext_tpu import validate as jvalidate
from recnext_tpu_torch import validate as tvalidate
from recnext_tpu_torch.export import publish_fused
from recnext_tpu_torch.models.registry import create_model, parse_kv_overrides
from recnext_tpu_torch.train import main as tmain
from recnext_tpu_torch.train.finetune import read_weights

SMALL = "embed_dim=16:32:64:128,depth=1:1:2:1"


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _train(out, *extra, classes=11, size=32, epochs=1):
    return tmain.main(["--device", "cpu", "--model", "recnext_m0", "--model-kwargs", SMALL,
                       "--data-set", "FAKE", "--simple-aug", "--input-size", str(size),
                       "--batch-size", "4", "--epochs", str(epochs), "--steps-per-epoch", "2",
                       "--fake-classes", str(classes), "--dtype", "float32",
                       "--log-every", "1", "--warmup-epochs", "0", "--output-dir", str(out),
                       *extra])


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """One epoch of the small M model on 11 classes: its checkpoint and a fused
    archive of its EMA weights."""
    root = tmp_path_factory.mktemp("pre")
    torch.set_num_threads(1)
    res = _train(root / "run")
    ckpt = root / "run" / "ckpt" / "epoch_0000.pt"
    archive = root / "pub"
    cfg = dict(embed_dim=(16, 32, 64, 128), depth=(1, 1, 2, 1), num_classes=11)
    model = create_model("recnext_m0", device="cpu", **cfg)
    model.load_state_dict(res["state"].variables(ema=True), strict=True)
    publish_fused("recnext_m0", model.state_dict(), str(archive))
    return ckpt, archive


@pytest.mark.parametrize("source", ["checkpoint", "archive"])
def test_finetune_with_grad_accum_remat_and_mesa(pretrained, tmp_path, capsys, source):
    ckpt, archive = pretrained
    path = ckpt if source == "checkpoint" else archive / "recnext_m0_fused.pt"
    res = _train(tmp_path, "--finetune", str(path), "--grad-accum", "2", "--remat",
                 "--mesa", "1.0", "--mesa-start-ratio", "0", classes=7, size=48)
    out = capsys.readouterr().out
    # the 11-class heads are dropped and reinitialised for 7 classes
    assert out.count("Removing key") == 4
    assert ("BN-fused" in out) == (source == "archive")
    assert ("using EMA weights" in out) == (source == "checkpoint")
    stats = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert len(stats) == 1 and np.isfinite(stats[0]["train_loss"])
    state = res["state"]
    assert state.step == 2 and state.optimizer.count == 1  # two micro-steps, one update
    # the warm start took the pretrained stem (then one update moved it by <= ~lr)
    pre = read_weights(str(ckpt))
    stem = state.model.state_dict()["stem.stem.0.conv.weight"]
    if source == "checkpoint":
        assert (stem - pre["stem.stem.0.conv.weight"]).abs().max() < 5e-3


def test_train_cli_refuses_option_clashes(tmp_path, capsys):
    # the JSD loss over 3 views trains (no mixup); --aug-splits alone is ignored, as the
    # JAX CLI ignores it without --jsd-loss
    for name, extra in (("jsd", ("--jsd-loss", "--aug-splits", "3", "--batch-size", "6")),
                        ("splits", ("--aug-splits", "3"))):
        res = _train(tmp_path / name, *extra)
        stats = [json.loads(line) for line in capsys.readouterr().out.splitlines()
                 if line.startswith("{")]
        assert len(stats) == 1 and np.isfinite(stats[0]["train_loss"])
        assert res["state"].step == 2
    with pytest.raises(SystemExit, match="requires --aug-splits >= 2"):
        _train(tmp_path, "--jsd-loss", "--aug-splits", "1")
    with pytest.raises(SystemExit, match="incompatible with distillation"):
        _train(tmp_path, "--jsd-loss", "--aug-splits", "2", "--distillation-type", "hard",
               "--teacher-model", "recnext_m0")
    with pytest.raises(SystemExit, match="EMA"):
        _train(tmp_path, "--mesa", "1.0", "--no-model-ema")
    with pytest.raises(NotImplementedError, match="item 9"):
        _train(tmp_path, "--finetune", str(tmp_path / "w.msgpack"))


def _validate(*args):
    return tvalidate.main(["--device", "cpu", "--model", "recnext_m0", "--model-kwargs",
                           SMALL, "--data-set", "FAKE", "--fake-classes", "11",
                           "--batch-size", "16", "--max-batches", "2", *args])


def test_validate_scores_every_checkpoint_format_into_its_csv(pretrained, tmp_path):
    ckpt, archive = pretrained
    results = tmp_path / "results.csv"
    rows = [_validate("--checkpoint", str(ckpt), "--input-size", "32", "--crop-pct", "1.0",
                      "--results-file", str(results)),
            _validate("--checkpoint", str(ckpt), "--ema", "--fused", "--input-size", "32",
                      "--results-file", str(results)),
            _validate("--checkpoint", str(archive), "--fused", "--input-size", "32",
                      "--results-file", str(results))]
    with open(results, newline="") as f:
        back = list(csv.DictReader(f))
    assert len(back) == 3
    for row, rec in zip(back, rows):
        assert rec["count"] == 32 and rec["device"] == "cpu"
        assert float(row["top1"]) == rec["top1"] and int(row["count"]) == 32
        assert row["fused"] == str(rec["fused"]) and row["model"] == "recnext_m0"
        assert float(row["crop_pct"]) == rec["crop_pct"]
    # the fused archive holds the EMA weights: the same scores as the EMA, fused
    assert rows[1]["top1"] == rows[2]["top1"] and rows[1]["top5"] == rows[2]["top5"]
    # a fused archive without --fused is refused
    with pytest.raises(SystemExit, match="--fused"):
        _validate("--checkpoint", str(archive), "--input-size", "32")


def test_validate_test_pool_and_valid_labels(pretrained, tmp_path):
    ckpt, _ = pretrained
    labels = tmp_path / "valid.txt"
    labels.write_text("\n".join(str(i) for i in (0, 2, 3, 5, 7, 10)))
    rec = _validate("--checkpoint", str(ckpt), "--fused", "--input-size", "256",
                    "--test-pool", "--valid-labels", str(labels), "--max-batches", "1")
    assert rec["test_pool"] and rec["crop_pct"] == 1.0 and rec["count"] == 16
    rec = _validate("--checkpoint", str(ckpt), "--fused", "--input-size", "32", "--test-pool")
    assert not rec["test_pool"]
    with pytest.raises(SystemExit, match="requires --fused"):
        _validate("--test-pool", "--input-size", "256")


def test_validate_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 12"):
        _validate("--fused", "--packed")
    # --native-loader (once a raise naming the data pipeline's item) scores FAKE data on
    # the PIL route, as the JAX CLI does for a data set that is not on disk
    rec = _validate("--native-loader", "--input-size", "32")
    assert rec["count"] == 32 and rec["loader_route"] == "pil (not on disk)"
    with pytest.raises(SystemExit, match="file names"):
        _validate("--real-labels", "real.json", "--input-size", "32")


def test_validate_matches_the_jax_cli_on_a_reference_pth(tmp_path, monkeypatch):
    """The same raw state dict (1000 classes, the JAX CLI's FAKE default) scored by both
    CLIs, unfused in f32 and fused: the same counts, top-1 and top-5. (The JAX CLI's
    --model-kwargs takes no tuples, so its parser is handed the small widths.)"""
    from recnext_tpu.models import registry as jregistry

    monkeypatch.setattr(jregistry, "parse_kv_overrides", lambda spec: dict(
        embed_dim=(16, 32, 64, 128), depth=(1, 1, 2, 1)))
    model = create_model("recnext_m0", device="cpu", embed_dim=(16, 32, 64, 128),
                         depth=(1, 1, 2, 1), num_classes=1000,
                         generator=torch.Generator().manual_seed(4))
    torch.save({"model": model.state_dict()}, tmp_path / "m0.pth")
    for fused in ([], ["--fused"]):
        args = ["--model", "recnext_m0", "--model-kwargs", SMALL, "--data-set", "FAKE",
                "--checkpoint", str(tmp_path / "m0.pth"), "--input-size", "32",
                "--batch-size", "16", "--max-batches", "2", *fused]
        want = jvalidate.main(args)
        got = tvalidate.main(["--device", "cpu", *args])
        for key in ("count", "top1", "top5", "img_size", "crop_pct", "fused"):
            assert got[key] == want[key], key


def test_bench_times_the_finetune_step_on_the_cpu():
    from recnext_tpu_torch import bench

    ips, batch, spread = bench.train_throughput(
        "recnext_m0", 4, timed_s=0.05, image_size=48, repeats=1, device="cpu",
        grad_accum=2, remat=True, mesa=1.0, num_classes=11,
        **parse_kv_overrides(SMALL))
    assert ips > 0 and batch == 4 and spread
