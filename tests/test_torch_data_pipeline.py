"""The port's data pipeline against the JAX package's on the CPU, bit for bit: the
samplers, the reference recipe's train transform (each RandAugment op forced),
every data set class on files, the train and eval loaders (the repeated-augmentation
sampler, augmentation splits, a rank of two), worker processes against the
in-process thread, a worker's failure, the trainer CLI on a folder of JPEGs (the
full transform, the JSD loss's views, workers, the native decoder), validate.py and
the contact sheet. The port's batches are NCHW, the JAX package's NHWC."""

import io
import json
import pickle
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from recnext_tpu.data import browse as jbrowse
from recnext_tpu.data import datasets as jds
from recnext_tpu.data import loader as jloader
from recnext_tpu.data import samplers as jsamplers
from recnext_tpu.data import transforms as jtf
from recnext_tpu_torch import bench
from recnext_tpu_torch import validate as tvalidate
from recnext_tpu_torch.data import browse as tbrowse
from recnext_tpu_torch.data import datasets as tds
from recnext_tpu_torch.data import loader as tloader
from recnext_tpu_torch.data import samplers as tsamplers
from recnext_tpu_torch.data import transforms as ttf
from recnext_tpu_torch.train import main as tmain

SMALL = "embed_dim=16:32:64:128,depth=1:1:2:1"


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def nhwc(batch):
    return batch["image"].numpy().transpose(0, 2, 3, 1)


def assert_same_batches(port, jax):
    assert len(port) == len(jax) > 0
    for t, j in zip(port, jax):
        assert t["image"].dtype == torch.float32 and t["label"].dtype == torch.int64
        np.testing.assert_array_equal(t["label"].numpy(), j["label"])
        np.testing.assert_array_equal(nhwc(t), j["image"])


# ---------------------------------------------------------------- samplers ----

@pytest.mark.parametrize("n", [7, 256, 300, 1000])
@pytest.mark.parametrize("epoch", [0, 5])
@pytest.mark.parametrize("rank,replicas", [(0, 1), (1, 2), (3, 4)])
def test_samplers_match_jax(n, epoch, rank, replicas):
    np.testing.assert_array_equal(tsamplers.ra_sampler_indices(n, epoch, rank, replicas),
                                  jsamplers.ra_sampler_indices(n, epoch, rank, replicas))
    np.testing.assert_array_equal(
        tsamplers.ra_sampler_indices(n, epoch, rank, replicas, shuffle=False),
        jsamplers.ra_sampler_indices(n, epoch, rank, replicas, shuffle=False))
    np.testing.assert_array_equal(tsamplers.distributed_eval_indices(n, rank, replicas),
                                  jsamplers.distributed_eval_indices(n, rank, replicas))


# -------------------------------------------------------------- transforms ----

def _photo(seed=0, w=70, h=50):
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    arr = np.stack([(xx * 3 + seed * 31) % 256, (yy * 5) % 256, rng.integers(0, 256, (h, w))],
                   -1).astype(np.uint8)
    return Image.fromarray(arr)


CONFIGS = {"randaugment": {}, "three_augment": {"three_augment": True},
           "jitter_only": {"auto_augment": False}, "erasing": {"reprob": 1.0},
           "no_erasing": {"reprob": 0.0}, "magnitude_3": {"ra_magnitude": 3.0}}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_train_transform_matches_jax(config):
    img = _photo()
    kw = CONFIGS[config]
    for seed in range(24):
        want = jtf.TrainTransform(32, **kw)(np.random.default_rng(seed), img)
        got = ttf.TrainTransform(32, **kw)(np.random.default_rng(seed), img)
        assert got.shape == (3, 32, 32) and got.dtype == np.float32
        np.testing.assert_array_equal(got.transpose(1, 2, 0), want)
    # post_crop alone, on a uint8 array (the native route's input)
    arr = np.asarray(_photo(1, 32, 32))
    want = jtf.TrainTransform(32, **kw).post_crop(np.random.default_rng(3), arr)
    got = ttf.TrainTransform(32, **kw).post_crop(np.random.default_rng(3), arr)
    np.testing.assert_array_equal(got.transpose(1, 2, 0), want)


def test_random_erasing_draws_its_noise_in_hwc_order():
    """The same draws put the same noise on each pixel: the noise is drawn as (h, w, C)
    on the HWC array, then transposed."""
    img = _photo()
    for seed in range(8):
        want = jtf.TrainTransform(32, reprob=1.0, auto_augment=False, jitter=0.0)(
            np.random.default_rng(seed), img)
        got = ttf.TrainTransform(32, reprob=1.0, auto_augment=False, jitter=0.0)(
            np.random.default_rng(seed), img)
        np.testing.assert_array_equal(got.transpose(1, 2, 0), want)
        assert (want != jtf.normalize(np.asarray(want))).any()  # something was erased


OPS = [name for name, _, _ in jtf._RA_OPS]


def test_the_op_table_is_the_jax_one():
    assert [name for name, _, _ in ttf._RA_OPS] == OPS and len(OPS) == 15
    assert ttf._FILL == jtf._FILL


@pytest.mark.parametrize("op", OPS)
def test_each_randaugment_op_matches_jax(op, monkeypatch):
    """RandAugment with its table cut to one op and probability 1, at magnitudes from
    0 to 10 (posterize reaches 0 bits at 10)."""
    k = OPS.index(op)
    monkeypatch.setattr(jtf, "_RA_OPS", [jtf._RA_OPS[k]])
    monkeypatch.setattr(ttf, "_RA_OPS", [ttf._RA_OPS[k]])
    img = _photo(2, 40, 30)
    for m in (0.0, 4.0, 9.0, 10.0):
        for seed in range(4):
            want = jtf.rand_augment(np.random.default_rng(seed), img, magnitude=m, prob=1.0)
            got = ttf.rand_augment(np.random.default_rng(seed), img, magnitude=m, prob=1.0)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    lvl_j, lvl_t = jtf._RA_OPS[0][2], ttf._RA_OPS[0][2]
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    assert [lvl_t(rt, m) for m in (0.0, 5.0, 10.0)] == [lvl_j(rj, m) for m in (0.0, 5.0, 10.0)]


def test_simple_train_transform_signals_a_fused_native_normalize():
    assert ttf.SimpleTrainTransform.post_crop is None
    assert callable(ttf.TrainTransform(32).post_crop)


# ---------------------------------------------------------------- datasets ----

def _class_folder(root, n_per_class=3, classes=("b", "a"), fmt="JPEG", size=(40, 30)):
    for ci, cls in enumerate(classes):
        d = root / cls
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n_per_class):
            _photo(ci * 10 + i, *size).save(d / f"{i}.{'jpg' if fmt == 'JPEG' else 'png'}",
                                            fmt, quality=90)


def _same_items(t, j):
    assert len(t) == len(j) and t.nb_classes == j.nb_classes
    for i in range(len(j)):
        (ti, tl), (ji, jl) = t[i], j[i]
        assert tl == jl and ti.size == ji.size and ti.mode == ji.mode
        np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))


def test_image_folder_matches_jax(tmp_path):
    _class_folder(tmp_path / "train")
    (tmp_path / "train" / "a" / "notes.txt").write_text("not an image")
    t, j = tds.ImageFolder(tmp_path / "train"), jds.ImageFolder(tmp_path / "train")
    assert [(str(p), lbl) for p, lbl in t.samples] == [(str(p), lbl) for p, lbl in j.samples]
    assert t.class_to_idx == j.class_to_idx == {"a": 0, "b": 1}
    _same_items(t, j)


def _tar(root, folder):
    path = root / "train.tar"
    with tarfile.open(path, "w") as tf:
        for p in sorted(folder.rglob("*.jpg")):
            tf.add(p, arcname=f"{p.parent.name}/{p.name}")
        info = tarfile.TarInfo("README")  # a member outside any class dir is skipped
        info.size = 2
        tf.addfile(info, io.BytesIO(b"hi"))
    return path


def test_tar_image_folder_matches_jax_and_pickles_without_its_handles(tmp_path):
    _class_folder(tmp_path / "src")
    path = _tar(tmp_path, tmp_path / "src")
    t, j = tds.TarImageFolder(path), jds.TarImageFolder(path)
    assert t.samples == j.samples and len(t) == 6
    _same_items(t, j)
    assert t._handles  # this process's handle is open
    again = pickle.loads(pickle.dumps(t))
    assert again._handles == {}
    np.testing.assert_array_equal(np.asarray(again[4][0]), np.asarray(j[4][0]))


def test_cifar100_matches_jax(tmp_path):
    d = tmp_path / "cifar-100-python"
    d.mkdir()
    rng = np.random.default_rng(0)
    for split, n in (("train", 5), ("test", 3)):
        with open(d / split, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"fine_labels": list(rng.integers(0, 100, n))}, f)
    for train in (True, False):
        _same_items(tds.CIFAR100(tmp_path, train=train), jds.CIFAR100(tmp_path, train=train))
    t, n = tds.build_dataset(True, "CIFAR", str(tmp_path))
    assert n == 100 and len(t) == 5


def _inat(root):
    (root / "imgs").mkdir(parents=True)
    categories = [{"id": 10, "name": "sp_a", "kingdom": "Animalia"},
                  {"id": 20, "name": "sp_b", "kingdom": "Plantae"},
                  {"id": 30, "name": "sp_c", "kingdom": "Animalia"}]
    for year in (2018, 2019):
        for split in ("train", "val"):
            images, annotations = [], []
            for i, cat in enumerate([10, 20, 30, 10]):
                fn = f"imgs/{split}{year}_{i}.jpg"
                _photo(i, 24, 20).save(root / fn)
                images.append({"id": i, "file_name": fn})
                annotations.append({"image_id": i, "category_id": cat})
            (root / f"{split}{year}.json").write_text(
                json.dumps({"images": images, "annotations": annotations}))
    (root / "categories.json").write_text(json.dumps(categories))


@pytest.mark.parametrize("category", ["name", "kingdom"])
def test_inat_matches_jax(tmp_path, category):
    _inat(tmp_path)
    for train in (True, False):
        t = tds.INatDataset(tmp_path, train=train, year=2019, category=category)
        j = jds.INatDataset(str(tmp_path), train=train, year=2019, category=category)
        assert [lbl for _, lbl in t.samples] == [lbl for _, lbl in j.samples]
        _same_items(t, j)


def test_every_branch_of_build_dataset_matches_jax(tmp_path):
    for split in ("train", "val", "test"):
        _class_folder(tmp_path / split, n_per_class=2)
    _tar_root = tmp_path / "tarred"
    _tar_root.mkdir()
    _tar(_tar_root, tmp_path / "train")
    _inat(tmp_path / "inat")
    cases = [("IMNET", tmp_path), ("IMNET", _tar_root), ("IMNETEE", tmp_path),
             ("FLOWERS", tmp_path), ("FOLDER", tmp_path), ("INAT", tmp_path / "inat"),
             ("INAT19", tmp_path / "inat"), ("FAKE", "")]
    for data_set, path in cases:
        for is_train in (True, False):
            if data_set == "IMNET" and path == _tar_root and not is_train:
                continue  # no val.tar: IMNET then reads <path>/val, which is absent
            t, tn = tds.build_dataset(is_train, data_set, str(path), 24, 7)
            j, jn = jds.build_dataset(is_train, data_set, str(path), 24, 7)
            assert (type(t).__name__, tn, len(t)) == (type(j).__name__, jn, len(j)), data_set
            for i in (0, len(j) - 1):
                np.testing.assert_array_equal(np.asarray(t[i][0]), np.asarray(j[i][0]))
                assert t[i][1] == j[i][1]
    with pytest.raises(ValueError, match="unknown data set"):
        tds.build_dataset(True, "MNIST", "")


# ----------------------------------------------------------------- loaders ----

@pytest.mark.parametrize("repeated_aug", [True, False])
@pytest.mark.parametrize("rank,replicas", [(0, 1), (1, 2)])
def test_train_loader_matches_jax(repeated_aug, rank, replicas):
    kw = dict(batch_size=4, epoch=2, seed=3, rank=rank, num_replicas=replicas,
              repeated_aug=repeated_aug)
    jb = list(jloader.train_loader(jds.FakeData(30, 24, 5), jtf.TrainTransform(16), **kw))
    loader = tloader.train_loader(tds.FakeData(30, 24, 5), ttf.TrainTransform(16), **kw)
    assert loader.route == "pil" and len(loader) == len(jb)
    assert_same_batches(list(loader), jb)


@pytest.mark.parametrize("splits", [2, 3])
def test_augmentation_splits_match_jax(splits):
    kw = dict(batch_size=3, epoch=1, seed=4, aug_splits=splits, rank=1, num_replicas=2)
    jb = list(jloader.train_loader(jds.FakeData(20, 24, 5), jtf.TrainTransform(16),
                                   clean_transform=jtf.SimpleTrainTransform(16), **kw))
    tb = list(tloader.train_loader(tds.FakeData(20, 24, 5), ttf.TrainTransform(16),
                                   clean_transform=ttf.SimpleTrainTransform(16), **kw))
    assert_same_batches(tb, jb)
    assert tb[0]["image"].shape[0] == 3 * splits
    labels = tb[0]["label"].numpy()
    assert (labels[:3] == labels[3:6]).all()


@pytest.mark.parametrize("rank,replicas", [(0, 1), (1, 2)])
def test_eval_loader_matches_jax(tmp_path, rank, replicas):
    _class_folder(tmp_path / "val", n_per_class=5, size=(50, 36))
    kw = dict(batch_size=4, rank=rank, num_replicas=replicas)
    jb = list(jloader.eval_loader(jds.ImageFolder(tmp_path / "val"), jtf.EvalTransform(24),
                                  **kw))
    tb = list(tloader.eval_loader(tds.ImageFolder(tmp_path / "val"), ttf.EvalTransform(24),
                                  **kw))
    assert_same_batches(tb, jb)


def test_workers_give_the_thread_s_bits(tmp_path):
    """Two worker processes against the in-process thread, PIL and tar: each batch's
    draws are seeded by its samples, not by the worker that built it."""
    _class_folder(tmp_path / "src", n_per_class=5)
    tar = tds.TarImageFolder(_tar(tmp_path, tmp_path / "src"))
    assert tar[0][1] == 0 and tar._handles  # the parent holds an open handle
    for ds in (tds.ImageFolder(tmp_path / "src"), tar):
        kw = dict(batch_size=3, epoch=0, seed=1)
        one = list(tloader.train_loader(ds, ttf.TrainTransform(24), **kw))
        two = tloader.train_loader(ds, ttf.TrainTransform(24), workers=2, **kw)
        got = list(two)
        assert len(got) == len(one) == 10 and two.native_fallback_batches == 0
        for a, b in zip(got, one):
            assert set(a) == {"image", "label"}
            assert torch.equal(a["image"], b["image"]) and torch.equal(a["label"], b["label"])


class Broken:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        raise OSError("corrupt sample")


@pytest.mark.parametrize("workers", [0, 2])
def test_a_worker_failure_reaches_the_consumer(workers):
    loader = tloader.train_loader(Broken(), ttf.SimpleTrainTransform(8), batch_size=2,
                                  epoch=0, workers=workers)
    with pytest.raises(RuntimeError, match="input pipeline") as err:
        list(loader)
    assert "corrupt sample" in repr(err.value.__cause__)


def test_a_consumer_that_stops_early_ends_the_workers():
    loader = tloader.train_loader(tds.FakeData(64, 20, 4), ttf.SimpleTrainTransform(16),
                                  batch_size=4, epoch=0, workers=2)
    for i, _ in enumerate(loader):
        if i == 2:
            break
    import multiprocessing

    for p in multiprocessing.active_children():
        p.join(timeout=30)
    assert not multiprocessing.active_children()


# ------------------------------------------------------------- the CLIs ----

@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A FOLDER data set of 24 small JPEGs a split, 3 classes (bench.make_folder's
    content)."""
    root = tmp_path_factory.mktemp("folder")
    bench.make_folder(root / "train", 24, classes=3, w=64, h=48)
    bench.make_folder(root / "val", 12, classes=3, w=64, h=48)
    return root


def _train(folder, out, *extra, epochs=1):
    return tmain.main(["--device", "cpu", "--model", "recnext_m0", "--model-kwargs", SMALL,
                       "--data-set", "FOLDER", "--data-path", str(folder), "--input-size",
                       "32", "--batch-size", "4", "--epochs", str(epochs),
                       "--steps-per-epoch", "2", "--dtype", "float32", "--log-every", "1",
                       "--warmup-epochs", "0", "--output-dir", str(out), *extra])


def _epoch_lines(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("extra", [(), ("--ThreeAugment",), ("--no-aa", "--reprob", "0.5"),
                                   ("--no-repeated-aug",)],
                         ids=["full", "three_augment", "jitter_only", "no_repeated_aug"])
def test_train_cli_trains_on_a_folder_with_the_full_transform(folder, tmp_path, capsys,
                                                              extra):
    res = _train(folder, tmp_path, *extra)
    (stats,) = _epoch_lines(capsys.readouterr().out)
    assert np.isfinite(stats["train_loss"]) and np.isfinite(stats["test_loss"])
    assert stats["loader_route"] == stats["eval_loader_route"] == "pil"
    assert stats["workers"] == 0 and stats["native_fallback_batches"] == 0
    assert res["state"].model.cfg.num_classes == 3
    assert json.loads((tmp_path / "args.json").read_text())["data_path"] == str(folder)


def test_train_cli_takes_the_jsd_loss_over_three_views(folder, tmp_path, capsys, monkeypatch):
    seen = []
    real = tloader.train_loader

    def spy(*args, **kwargs):
        loader = real(*args, **kwargs)
        seen.append((kwargs["batch_size"], kwargs["aug_splits"],
                     type(kwargs["clean_transform"]).__name__))
        return loader

    monkeypatch.setattr(tloader, "train_loader", spy)
    res = _train(folder, tmp_path, "--jsd-loss", "--aug-splits", "3", "--batch-size", "6")
    (stats,) = _epoch_lines(capsys.readouterr().out)
    assert np.isfinite(stats["train_loss"])
    assert seen == [(2, 3, "SimpleTrainTransform")]  # 6 // 3 samples, 3 views each
    assert res["state"].step == 2


def test_train_cli_with_workers_and_the_native_decoder(folder, tmp_path, capsys):
    """Two worker processes, then the native decoder in them: the same run twice
    gives the same losses (the pixels do not depend on the route's workers)."""
    runs = {}
    for name, extra in (("workers", ("--workers", "2")),
                        ("native", ("--workers", "2", "--native-loader")),
                        ("native_thread", ("--native-loader",))):
        torch.manual_seed(0)
        _train(folder, tmp_path / name, *extra)
        out = capsys.readouterr().out
        (stats,) = _epoch_lines(out)
        runs[name] = [float(line.rsplit(" ", 1)[1]) for line in out.splitlines()
                      if ": loss " in line]
        assert stats["workers"] == (2 if "workers" in extra[0] else 0)
        assert stats["loader_route"] == stats["eval_loader_route"] == (
            "native" if "--native-loader" in extra else "pil")
        assert stats["native_fallback_batches"] == 0 and np.isfinite(stats["train_loss"])
    assert runs["native"] == runs["native_thread"] and len(runs["native"]) == 2


def test_validate_on_a_folder_native_and_pil(folder):
    base = ["--device", "cpu", "--model", "recnext_m0", "--model-kwargs", SMALL + ",num_classes=3",
            "--data-set", "FOLDER", "--data-path", str(folder), "--input-size", "32",
            "--batch-size", "5"]
    pil = tvalidate.main(base)
    nat = tvalidate.main(base + ["--native-loader"])
    assert pil["count"] == nat["count"] == 12
    assert (pil["loader_route"], nat["loader_route"]) == ("pil", "native")
    assert nat["native_fallback_batches"] == 0
    # the native crop-resample is PIL's geometry and kernel up to PIL's uint8 rounding
    assert abs(pil["top1"] - nat["top1"]) <= 100 / 12 + 1e-9


def test_contact_sheet_matches_jax(tmp_path):
    ds = jds.FakeData(6, 40, 3)
    kw = dict(rows=3, draws=4, seed=2)
    for tt, jt in ((ttf.TrainTransform(32), jtf.TrainTransform(32)),
                   (ttf.SimpleTrainTransform(32), jtf.SimpleTrainTransform(32))):
        got = tbrowse.contact_sheet(tds.FakeData(6, 40, 3), tt, ttf.EvalTransform(32), **kw)
        want = jbrowse.contact_sheet(ds, jt, jtf.EvalTransform(32), **kw)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    out = tmp_path / "sheet.png"
    sheet = tbrowse.main(["--data-set", "FAKE", "--input-size", "24", "--rows", "2",
                          "--draws", "3", "--out", str(out), "--three-augment"])
    assert Image.open(out).size == sheet.size == (5 * 26 + 2, 2 * 26 + 2)


def test_make_folder_writes_the_jax_bench_s_images(tmp_path):
    """bench.make_folder (threads encode) writes recnext_tpu/benchmark/bench_loader.py's
    files byte for byte; with classes, image i goes to class i % classes."""
    from recnext_tpu.benchmark import bench_loader

    bench.make_folder(tmp_path / "port", 20, w=80, h=60)
    bench_loader.make_folder(tmp_path / "jax", 20, w=80, h=60)
    for i in range(20):
        assert ((tmp_path / "port" / "c0" / f"{i:04d}.jpg").read_bytes()
                == (tmp_path / "jax" / "train" / "c0" / f"{i:04d}.jpg").read_bytes())
    bench.make_folder(tmp_path / "classes", 7, classes=3, w=40, h=30)
    ds = tds.ImageFolder(tmp_path / "classes")
    assert [(p.name, lbl) for p, lbl in ds.samples] == [
        ("0000.jpg", 0), ("0003.jpg", 0), ("0006.jpg", 0), ("0001.jpg", 1), ("0004.jpg", 1),
        ("0002.jpg", 2), ("0005.jpg", 2)]
