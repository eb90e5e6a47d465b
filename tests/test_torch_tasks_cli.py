"""The port's task CLIs on the CPU at small sizes (``--device cpu``, recnext_m0, 64^2),
after ``tests/test_cli_smoke.py``: ``train_seg`` trains, checkpoints (the last 3
kept), resumes, evaluates (``--eval-only``) and benchmarks on FAKE data, trains on an
ADE20K-layout folder with the validation split's mIoU, and loads a classification
checkpoint into its backbone (``--init-ckpt``); ``train_det --detector retinanet`` does
the same on FAKE data and on a COCO-format folder; the presets; and what the
detection CLI refuses (``--detector mask_rcnn``, its default, ``--with-mask`` and
``--num-proposals``)."""

import json

import pytest
import torch

from recnext_tpu_torch.tasks import train_det, train_seg
from recnext_tpu_torch.train import main as tmain
from tests.test_torch_tasks_det import coco_folder
from tests.test_torch_tasks_seg import _ade_folder


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _records(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _seg(out, *extra):
    return train_seg.main(["--device", "cpu", "--backbone", "recnext_m0", "--num-classes", "6",
                           "--crop", "64", "--batch-size", "2", "--output-dir", str(out),
                           *extra])


def test_train_seg_trains_resumes_evaluates_and_benchmarks(tmp_path, capsys):
    res = _seg(tmp_path, "--iters", "4", "--eval-every", "2")
    recs = _records(capsys)
    assert [r["iter"] for r in recs] == [2, 4] and res["state"].step == 4
    assert all(set(r) >= {"loss", "mIoU", "elapsed_s"} for r in recs)
    ckpt = tmp_path / "ckpt"
    assert sorted(p.name for p in ckpt.glob("iter_*.pt")) == ["iter_0002.pt", "iter_0004.pt"]
    res = _seg(tmp_path, "--iters", "7", "--eval-every", "2", "--ckpt-every", "1", "--resume")
    out = capsys.readouterr().out
    assert "resumed at iter 4" in out and res["state"].step == 7
    assert sorted(p.name for p in ckpt.glob("iter_*.pt")) == [
        "iter_0005.pt", "iter_0006.pt", "iter_0007.pt"]
    rec = _seg(tmp_path, "--eval-only")
    assert rec["iter"] == 7 and 0.0 <= rec["mIoU"] <= 100.0
    rec = _seg(tmp_path, "--benchmark", "2")
    assert rec["iters"] == 2 and rec["images_per_sec"] > 0
    with pytest.raises(SystemExit, match="no checkpoint"):
        _seg(tmp_path / "empty", "--eval-only")


def test_train_seg_on_an_ade20k_folder_with_its_validation_miou(tmp_path, capsys):
    root = _ade_folder(tmp_path / "ade", n=3)
    res = _seg(tmp_path / "run", "--data-set", "FOLDER", "--data-path", str(root),
               "--num-classes", "150", "--iters", "2", "--eval-every", "2")
    assert res["last"]["iter"] == 2 and 0.0 <= res["last"]["mIoU"] <= 100.0
    with pytest.raises(SystemExit, match="requires --data-path"):
        _seg(tmp_path / "x", "--data-set", "FOLDER")
    with pytest.raises(SystemExit, match="no image/annotation pairs"):
        _seg(tmp_path / "x", "--data-set", "FOLDER", "--data-path", str(tmp_path / "x"))


@pytest.fixture(scope="module")
def classifier_ckpt(tmp_path_factory):
    """One step of the classification trainer on recnext_m0 (full width): its
    checkpoint, whose EMA weights ``--init-ckpt`` reads."""
    out = tmp_path_factory.mktemp("cls")
    torch.set_num_threads(1)
    tmain.main(["--device", "cpu", "--model", "recnext_m0", "--data-set", "FAKE",
                "--simple-aug", "--input-size", "32", "--batch-size", "2", "--epochs", "1",
                "--steps-per-epoch", "1", "--fake-classes", "3", "--dtype", "float32",
                "--output-dir", str(out)])
    return out / "ckpt" / "epoch_0000.pt"


def test_init_ckpt_loads_the_classifier_into_each_task_backbone(tmp_path, classifier_ckpt):
    from recnext_tpu_torch.train.finetune import read_weights

    cls = read_weights(str(classifier_ckpt), log=lambda m: None)
    res = _seg(tmp_path / "seg", "--init-ckpt", str(classifier_ckpt), "--iters", "1",
               "--eval-every", "1", "--lr", "0")
    det = train_det.main(["--device", "cpu", "--backbone", "recnext_m0", "--detector",
                          "retinanet", "--num-classes", "3", "--img-size", "64",
                          "--batch-size", "2", "--epochs", "1", "--steps-per-epoch", "1",
                          "--eval-every", "0", "--lr", "0", "--init-ckpt",
                          str(classifier_ckpt), "--output-dir", str(tmp_path / "det")])
    for state, prefix in ((res["state"], "backbone."), (det["state"], "extractor.backbone.")):
        sd = state.model.state_dict()
        # lr 0 and frozen statistics (segmentation) leave the weights as loaded: every
        # parameter; the detector's backbone BN trains, so its statistics moved
        for k, v in cls.items():
            if k.startswith("head."):
                continue
            if prefix == "backbone." or not k.endswith(("running_mean", "running_var",
                                                        "num_batches_tracked")):
                assert torch.equal(sd[prefix + k], v), prefix + k


def _det(out, *extra):
    return train_det.main(["--device", "cpu", "--backbone", "recnext_m0", "--detector",
                           "retinanet", "--num-classes", "4", "--img-size", "64",
                           "--batch-size", "2", "--fake-size", "3", "--steps-per-epoch", "2",
                           "--output-dir", str(out), *extra])


def test_train_det_retinanet_trains_resumes_evaluates_and_benchmarks(tmp_path, capsys):
    res = _det(tmp_path, "--epochs", "1")
    rec = _records(capsys)[-1]
    assert rec["epoch"] == 0 and res["state"].step == 2
    assert {"train_loss", "bbox_mAP", "bbox_mAP_50", "bbox_mAP_75", "bbox_mAP_s"} <= set(rec)
    res = _det(tmp_path, "--epochs", "2", "--resume")
    assert "resumed from epoch 0" in capsys.readouterr().out and res["state"].step == 4
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("epoch_*.pt")) == [
        "epoch_0000.pt", "epoch_0001.pt"]
    rec = _det(tmp_path, "--eval-only", "--eval-max-images", "3")
    assert rec["epoch"] == 1 and "bbox_mAP" in rec
    rec = _det(tmp_path, "--benchmark", "1")
    assert rec["detector"] == "retinanet" and rec["images_per_sec"] > 0


def test_train_det_retinanet_on_a_coco_folder(tmp_path, capsys):
    root = coco_folder(tmp_path / "coco")
    ann = str(root / "annotations" / "instances_train2017.json")
    res = _det(tmp_path / "run", "--data-set", "COCO", "--data-path", str(root),
               "--val-ann-file", ann, "--val-img-dir", str(root / "train2017"), "--epochs", "1",
               "--steps-per-epoch", "1")
    rec = _records(capsys)[-1]
    assert res["state"].step == 1 and rec["bbox_mAP"] is not None
    assert res["state"].model.head.num_classes == 3  # the folder's categories


def test_presets_set_the_recipes_defaults():
    a = train_seg.parse_args(["--preset", "seg_recnext_m3_fpn_ade20k_40k"])
    assert (a.backbone, a.crop, a.batch_size, a.lr, a.iters, a.num_classes, a.eval_every) == (
        "recnext_m3", 512, 16, 1e-4, 40000, 150, 8000)
    assert train_seg.parse_args(["--preset", "seg_recnext_a3_fpn_ade20k_40k",
                                 "--crop", "256"]).crop == 256
    d = train_det.parse_args(["--preset", "det_recnext_m3_fpn_1x_coco", "--detector",
                              "retinanet"])
    assert (d.backbone, d.img_size, d.batch_size, d.lr, d.epochs, d.decay_epochs,
            d.num_classes, d.device) == ("recnext_m3", 800, 16, 2e-4, 12, [8, 11], 80, None)
    for parse, name in ((train_seg.parse_args, "seg_nope"), (train_det.parse_args, "det_nope")):
        with pytest.raises(SystemExit, match="unknown preset"):
            parse(["--preset", name])


def test_train_det_refuses_the_two_stage_detector_naming_its_item(tmp_path):
    for extra in ([], ["--detector", "mask_rcnn"], ["--detector", "retinanet", "--with-mask"],
                  ["--detector", "retinanet", "--num-proposals", "128"]):
        with pytest.raises(NotImplementedError, match="item 11's rest"):
            train_det.main(["--device", "cpu", "--output-dir", str(tmp_path), *extra])
