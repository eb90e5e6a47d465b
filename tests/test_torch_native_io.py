"""The port's binding of the native decoder (``native/recnext_io.cpp``) and its native
loaders against the JAX package's on the CPU: bit for bit against the JAX binding
and loaders, within ``tests/test_native_io.py``'s bounds against the PIL route; the
fallback to PIL on files the decoder refuses, the tar and augmentation-split routes,
worker processes, builds that race, and the errors a failed build raises. The
library links the libjpeg that Pillow bundles, not a system one, and decodes the
same bits as the JAX package's build (``-ljpeg``, the system's libjpeg).

The JAX binding is pointed at the port's build of the same source with the same
flags: the JAX package builds into ``native/build/`` with no lock and no atomic
rename, so these tests do not build it."""

import io
import subprocess
import sys
import tarfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from recnext_tpu.data import datasets as jds
from recnext_tpu.data import loader as jloader
from recnext_tpu.data import native as jnative
from recnext_tpu.data import transforms as jtf
from recnext_tpu_torch import bench
from recnext_tpu_torch.data import datasets as tds
from recnext_tpu_torch.data import loader as tloader
from recnext_tpu_torch.data import native as tnative
from recnext_tpu_torch.data import transforms as ttf
from recnext_tpu_torch.train import main as tmain

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def jax_binding(monkeypatch):
    monkeypatch.setattr(jnative, "_LIB", tnative.load())


def _jpeg(arr, quality=95):
    b = io.BytesIO()
    Image.fromarray(arr).save(b, "JPEG", quality=quality)
    return b.getvalue()


def _arr(seed, w, h):
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    return np.stack([(xx * 3 + seed * 31) % 256, (yy * 2) % 256,
                     rng.integers(0, 256, (h, w))], -1).astype(np.uint8)


def nhwc(batch):
    return batch["image"].numpy().transpose(0, 2, 3, 1)


def test_the_library_is_built_into_the_port_s_build_directory():
    path = tnative.library_path()
    assert path.parent == REPO / "recnext_tpu_torch" / "_build" and path.exists()
    assert path.name.startswith("librecnext_io-") and tnative.load().rn_version() == 3


def test_the_library_links_pillow_s_libjpeg():
    """Pillow's libjpeg by its full path, found through the rpath; no system libjpeg."""
    tnative.load()
    path = tnative.library_path()
    libjpeg = tnative.pillow_libjpeg()
    assert libjpeg.parent.name == "pillow.libs" and ".so.62" in libjpeg.name
    dynamic = subprocess.run(["readelf", "-d", str(path)], capture_output=True, text=True,
                             check=True).stdout
    needed = [line.split("[", 1)[1].rstrip("]") for line in dynamic.splitlines()
              if "(NEEDED)" in line]
    assert [n for n in needed if "jpeg" in n] == [libjpeg.name]
    assert str(libjpeg.parent) in dynamic  # the RUNPATH
    resolved = subprocess.run(["ldd", str(path)], capture_output=True, text=True,
                              check=True).stdout
    jpeg_lines = [line for line in resolved.splitlines() if "jpeg" in line]
    assert len(jpeg_lines) == 1 and str(libjpeg) in jpeg_lines[0], resolved


def test_without_pillow_s_libjpeg_the_build_raises(unbuilt, monkeypatch, tmp_path):
    import PIL

    monkeypatch.setattr(PIL, "__file__", str(tmp_path / "site" / "PIL" / "__init__.py"))
    with pytest.raises(tnative.NativeBuildError, match="bundles no libjpeg"):
        tnative.load()
    assert not list(unbuilt.glob("*.so"))


def test_pillow_libjpeg_build_decodes_the_system_build_s_bits(tmp_path):
    """The source built as the JAX package builds it (``-ljpeg``: the system's libjpeg
    and headers) decodes, crops and resizes the same bits as the port's build, on
    JPEGs of quality 50-95, 4:4:4, 4:2:2 and 4:2:0 subsampling, 48x64 to 500x375; the
    system build runs in a process of its own, so that the two libjpegs never share
    one."""
    system = tmp_path / "librecnext_io-system.so"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(tnative.SOURCE), "-o",
                    str(system), "-ljpeg", "-lpthread"], check=True, timeout=300)
    cases = [(50, 0, 64, 48), (75, 1, 500, 375), (90, 2, 130, 97), (95, 2, 33, 200),
             (85, 1, 48, 64), (60, 0, 321, 211)]
    blobs = []
    for i, (quality, subsampling, w, h) in enumerate(cases):
        b = io.BytesIO()
        Image.fromarray(_arr(i, w, h)).save(b, "JPEG", quality=quality,
                                            subsampling=subsampling)
        blobs.append(b.getvalue())
    crops = np.array([[3.5, 2.25, 20.0, 17.5, 1], [0, 0, 0, 0, 0]] * 3, np.float32)
    np.savez(tmp_path / "in.npz", *[np.frombuffer(b, np.uint8) for b in blobs])
    code = textwrap.dedent(f"""
        import ctypes
        import numpy as np
        from recnext_tpu_torch.data import native
        lib = ctypes.CDLL({str(system)!r})
        native._declare(lib)
        native._lib = lib
        blobs = [a.tobytes() for a in np.load({str(tmp_path / "in.npz")!r}).values()]
        crops = np.array({crops.tolist()!r}, np.float32)
        out = {{f"decode{{i}}": native.decode_jpeg(b) for i, b in enumerate(blobs)}}
        out["crop"] = native.batch_decode_crop(blobs, crops, 40)
        out["crop_u8"] = native.batch_decode_crop_u8(blobs, crops, 40)
        np.savez({str(tmp_path / "out.npz")!r}, **out)
    """)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
    want = np.load(tmp_path / "out.npz")
    for i, b in enumerate(blobs):
        got = tnative.decode_jpeg(b)
        assert got.shape == (cases[i][3], cases[i][2], 3)
        np.testing.assert_array_equal(got, want[f"decode{i}"])
        np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(b)).convert("RGB")))
    np.testing.assert_array_equal(tnative.batch_decode_crop(blobs, crops, 40), want["crop"])
    np.testing.assert_array_equal(tnative.batch_decode_crop_u8(blobs, crops, 40),
                                  want["crop_u8"])


def test_decode_matches_jax_and_pil():
    for seed, (w, h) in enumerate([(130, 97), (64, 64), (33, 200)]):
        blob = _jpeg(_arr(seed, w, h))
        got = tnative.decode_jpeg(blob)
        np.testing.assert_array_equal(got, jnative.decode_jpeg(blob))
        np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(blob)).convert("RGB")))
    png = io.BytesIO()
    Image.fromarray(_arr(0, 20, 20)).save(png, "PNG")
    assert tnative.decode_jpeg(png.getvalue()) is None is jnative.decode_jpeg(png.getvalue())


def _crops(rng, n, w, h):
    rows = []
    for i in range(n):
        cw, ch = rng.uniform(8, w), rng.uniform(8, h)
        rows.append([rng.uniform(0, w - cw), rng.uniform(0, h - ch), cw, ch, float(i % 2)])
    rows[0] = [0, 0, -1, -1, 0]  # the whole image
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("size", [24, 64])
def test_batch_decode_crop_matches_jax(size):
    rng = np.random.default_rng(1)
    blobs = [_jpeg(_arr(i, 150, 120)) for i in range(6)]
    crops = _crops(rng, 6, 150, 120)
    got = tnative.batch_decode_crop(blobs, crops, size)
    assert got.shape == (6, size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jnative.batch_decode_crop(blobs, crops, size))
    u8 = tnative.batch_decode_crop_u8(blobs, crops, size)
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(u8, jnative.batch_decode_crop_u8(blobs, crops, size))


def test_batch_decode_crop_u8_is_pil_s_box_resize_within_one_level():
    """tests/test_native_io.py's bound: PIL rounds between its two passes, the decoder
    once at the end."""
    blob = _jpeg(_arr(3, 150, 120))
    src = Image.open(io.BytesIO(blob)).convert("RGB")
    x, y, cw, ch = 10, 20, 100, 80
    want = np.asarray(src.resize((64, 64), Image.BICUBIC, box=(x, y, x + cw, y + ch)))
    got = tnative.batch_decode_crop_u8([blob], np.asarray([[x, y, cw, ch, 0]], np.float32),
                                       64)[0]
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and d.mean() < 0.2


def test_a_refused_file_fails_the_batch():
    png = io.BytesIO()
    Image.fromarray(_arr(0, 20, 20)).save(png, "PNG")
    blobs = [_jpeg(_arr(1, 30, 30)), png.getvalue()]
    crops = np.zeros((2, 5), np.float32)
    assert tnative.batch_decode_crop(blobs, crops, 16) is None
    assert tnative.batch_decode_crop_u8(blobs, crops, 16) is None


def _folder(root, n=12, classes=3, pngs=()):
    bench.make_folder(root, n, classes=classes, w=90, h=70)
    for i in pngs:  # the same content as a PNG, in place of the JPEG
        jpg = next(root.rglob(f"{i:04d}.jpg"))
        Image.open(jpg).save(jpg.with_suffix(".png"), "PNG")
        jpg.unlink()
    return root


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    return _folder(tmp_path_factory.mktemp("jpegs") / "train")


@pytest.fixture(scope="module")
def with_pngs(tmp_path_factory):
    return _folder(tmp_path_factory.mktemp("pngs") / "train", pngs=(2, 7))


TRANSFORMS = {"full": (ttf.TrainTransform, jtf.TrainTransform),
              "simple": (ttf.SimpleTrainTransform, jtf.SimpleTrainTransform),
              "three_augment": (lambda s: ttf.TrainTransform(s, three_augment=True),
                                lambda s: jtf.TrainTransform(s, three_augment=True))}


@pytest.mark.parametrize("kind", sorted(TRANSFORMS))
@pytest.mark.parametrize("repeated_aug", [True, False])
def test_native_train_loader_matches_jax(jpegs, kind, repeated_aug):
    tt, jt = TRANSFORMS[kind]
    kw = dict(batch_size=4, epoch=1, seed=5, repeated_aug=repeated_aug)
    loader = tloader.train_loader(tds.ImageFolder(jpegs), tt(40), native=True, **kw)
    got = list(loader)
    want = list(jloader.train_loader(jds.ImageFolder(str(jpegs)), jt(40), native=True, **kw))
    assert loader.route == "native" and loader.native_fallback_batches == 0
    assert len(got) == len(want) > 0
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t["label"].numpy(), j["label"])
        np.testing.assert_array_equal(nhwc(t), j["image"])


def test_native_train_loader_is_the_pil_route_within_its_bounds(jpegs):
    """tests/test_native_io.py's bounds: the simple transform within 0.02 (mean
    0.005) in [0, 1] units; the full one's rare posterize/solarize bucket crossings."""
    kw = dict(batch_size=4, epoch=0, seed=9)
    for tf in (ttf.SimpleTrainTransform(48), ttf.TrainTransform(48)):
        nat = list(tloader.train_loader(tds.ImageFolder(jpegs), tf, native=True, **kw))
        pil = list(tloader.train_loader(tds.ImageFolder(jpegs), tf, native=False, **kw))
        assert len(nat) == len(pil) > 0
        for bn, bp in zip(nat, pil):
            assert torch.equal(bn["label"], bp["label"])
            d = np.abs(nhwc(bn) - nhwc(bp)) * ttf.IMAGENET_STD
            if tf.post_crop is None:
                assert d.max() < 0.02 and d.mean() < 0.005
            else:
                assert d.mean() < 0.01 and (d > 0.1).mean() < 0.02


@pytest.mark.parametrize("size,crop_pct", [(32, 224 / 256), (48, 1.0)])
def test_native_eval_loader_matches_jax(jpegs, size, crop_pct):
    kw = dict(batch_size=5, rank=1, num_replicas=2)
    loader = tloader.eval_loader(tds.ImageFolder(jpegs), ttf.EvalTransform(size, crop_pct),
                                 native=True, **kw)
    got = list(loader)
    want = list(jloader.eval_loader(jds.ImageFolder(str(jpegs)),
                                    jtf.EvalTransform(size, crop_pct), native=True, **kw))
    assert loader.route == "native" and [len(b["label"]) for b in got] == [5, 1]
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t["label"].numpy(), j["label"])
        np.testing.assert_array_equal(nhwc(t), j["image"])
    pil = list(tloader.eval_loader(tds.ImageFolder(jpegs), ttf.EvalTransform(size, crop_pct),
                                   **kw))
    d = np.abs(np.concatenate([nhwc(b) for b in got])
               - np.concatenate([nhwc(b) for b in pil])) * ttf.IMAGENET_STD
    assert d.max() < 0.02 and d.mean() < 0.005


@pytest.mark.parametrize("kind", ["full", "simple"])
def test_a_batch_with_a_png_falls_back_to_pil_as_the_jax_loader_does(with_pngs, kind):
    tt, jt = TRANSFORMS[kind]
    kw = dict(batch_size=4, epoch=0, seed=2, repeated_aug=False)
    loader = tloader.train_loader(tds.ImageFolder(with_pngs), tt(32), native=True, **kw)
    got = list(loader)
    want = list(jloader.train_loader(jds.ImageFolder(str(with_pngs)), jt(32), native=True,
                                     **kw))
    pil = list(tloader.train_loader(tds.ImageFolder(with_pngs), tt(32), **kw))
    assert loader.route == "native" and len(got) == len(want) == 3
    assert 1 <= loader.native_fallback_batches <= 2
    fell_back = 0
    for t, j, p in zip(got, want, pil):
        np.testing.assert_array_equal(nhwc(t), j["image"])
        fell_back += torch.equal(t["image"], p["image"])  # fresh draws: the PIL batch
    assert fell_back == loader.native_fallback_batches
    ev = tloader.eval_loader(tds.ImageFolder(with_pngs), ttf.EvalTransform(32), batch_size=4,
                             native=True)
    evb = list(ev)
    jev = list(jloader.eval_loader(jds.ImageFolder(str(with_pngs)), jtf.EvalTransform(32),
                                   batch_size=4, native=True))
    assert ev.native_fallback_batches == 2  # a batch a class; c1 and c2 hold a PNG
    for t, j in zip(evb, jev):
        np.testing.assert_array_equal(nhwc(t), j["image"])


def test_tar_and_augmentation_splits_take_the_pil_route(jpegs, tmp_path):
    tar = tmp_path / "train.tar"
    with tarfile.open(tar, "w") as tf:
        for p in sorted(jpegs.rglob("*.jpg")):
            tf.add(p, arcname=f"{p.parent.name}/{p.name}")
    kw = dict(batch_size=4, epoch=0, seed=1)
    loader = tloader.train_loader(tds.TarImageFolder(tar), ttf.TrainTransform(32), native=True,
                                  **kw)
    want = list(jloader.train_loader(jds.TarImageFolder(str(tar)), jtf.TrainTransform(32),
                                     native=True, **kw))
    got = list(loader)
    assert loader.route == "pil (not on disk)" and len(got) == len(want)
    for t, j in zip(got, want):
        np.testing.assert_array_equal(nhwc(t), j["image"])
    ev = tloader.eval_loader(tds.TarImageFolder(tar), ttf.EvalTransform(32), batch_size=4,
                             native=True)
    assert ev.route == "pil (not on disk)"
    splits = tloader.train_loader(tds.ImageFolder(jpegs), ttf.TrainTransform(32), native=True,
                                  aug_splits=2, clean_transform=ttf.SimpleTrainTransform(32),
                                  **kw)
    want = list(jloader.train_loader(jds.ImageFolder(str(jpegs)), jtf.TrainTransform(32),
                                     native=True, aug_splits=2,
                                     clean_transform=jtf.SimpleTrainTransform(32), **kw))
    assert splits.route == "pil (aug splits)"
    for t, j in zip(list(splits), want):
        np.testing.assert_array_equal(nhwc(t), j["image"])


def test_native_route_in_workers_gives_the_thread_s_bits(with_pngs):
    kw = dict(batch_size=4, epoch=0, seed=3, native=True)
    one = tloader.train_loader(tds.ImageFolder(with_pngs), ttf.TrainTransform(32), **kw)
    two = tloader.train_loader(tds.ImageFolder(with_pngs), ttf.TrainTransform(32), workers=2,
                               **kw)
    a, b = list(one), list(two)
    assert len(a) == len(b) == 9
    assert one.native_fallback_batches == two.native_fallback_batches > 0
    for x, y in zip(a, b):
        assert torch.equal(x["image"], y["image"]) and torch.equal(x["label"], y["label"])


def test_builds_that_race_leave_one_whole_library(tmp_path):
    """Four processes build into one path at once: each loads a whole library, and no
    temporary file is left."""
    out = tmp_path / "librecnext_io-race.so"
    code = textwrap.dedent(f"""
        import ctypes, sys
        from pathlib import Path
        from recnext_tpu_torch.data import native
        native._build(Path({str(out)!r}))
        print(ctypes.CDLL({str(out)!r}).rn_version())
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    results = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, results
    assert [r[0].strip() for r in results] == ["3"] * 4
    assert {p.name for p in tmp_path.iterdir()} == {out.name, "librecnext_io-race.lock"}


@pytest.fixture
def unbuilt(monkeypatch, tmp_path):
    """The binding with nothing loaded, building into ``tmp_path``."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    return tmp_path


def test_a_failed_build_raises_and_the_native_route_does_not_fall_back(unbuilt, monkeypatch,
                                                                       jpegs):
    data = unbuilt / "data"
    for split in ("train", "val"):
        bench.make_folder(data / split, 4, classes=2, w=40, h=30)
    bad = unbuilt / "broken.cpp"
    bad.write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    with pytest.raises(tnative.NativeBuildError, match="no_such_header"):
        tnative.load()
    assert not list(unbuilt.glob("*.so")) and not list(unbuilt.glob("*.tmp"))
    with pytest.raises(tnative.NativeBuildError):
        tloader.train_loader(tds.ImageFolder(jpegs), ttf.TrainTransform(32), batch_size=4,
                             epoch=0, native=True)
    with pytest.raises(tnative.NativeBuildError):
        tloader.eval_loader(tds.ImageFolder(jpegs), ttf.EvalTransform(32), batch_size=4,
                            native=True)
    with pytest.raises(tnative.NativeBuildError):
        tmain.main(["--device", "cpu", "--model", "recnext_m0", "--model-kwargs",
                    "embed_dim=16:32:64:128,depth=1:1:2:1", "--data-set", "FOLDER",
                    "--data-path", str(data), "--native-loader", "--input-size", "32",
                    "--batch-size", "4", "--epochs", "1", "--steps-per-epoch", "1",
                    "--output-dir", str(unbuilt / "run")])
    monkeypatch.setattr(tnative, "SOURCE", unbuilt / "missing.cpp")
    with pytest.raises(tnative.NativeBuildError, match="missing"):
        tnative.load()


def test_a_library_of_another_abi_is_refused(unbuilt, monkeypatch):
    monkeypatch.setattr(tnative, "ABI_VERSION", 99)
    with pytest.raises(tnative.NativeBuildError, match="ABI version 3, expected 99"):
        tnative.load()
