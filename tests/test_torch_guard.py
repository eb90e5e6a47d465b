"""Guards of the port's boundaries: it imports nothing of JAX or of the JAX package,
and its entry points run on the GPU unless told otherwise (without one, they raise
instead of running on the CPU)."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from recnext_tpu_torch.device import resolve_device
from recnext_tpu_torch.models.registry import create_model
from recnext_tpu_torch.serve import ServingModel

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import recnext_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(recnext_tpu_torch.__path__,
                                                       "recnext_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        # the data pipeline's modules are among them
        data = {"recnext_tpu_torch.data." + m for m in
                ("samplers", "transforms", "datasets", "native", "loader", "browse")}
        assert data <= set(names), data - set(names)
        # the downstream tasks' modules too, the two-stage detector's among them
        tasks = {"recnext_tpu_torch.tasks." + m for m in
                 ("configs", "fpn", "segmentation", "boxes", "detection", "coco_eval",
                  "train_seg", "train_det", "roi", "mask_rcnn")} | {"recnext_tpu_torch.data.coco"}
        assert tasks <= set(names), tasks - set(names)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "flax", "recnext_tpu"))
        print(len(names), bad)
        assert not bad, bad
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 29  # every module was imported


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")


def test_device_helper_defaults_to_the_gpu_and_raises_without_one(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_a_gpu(no_gpu, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("recnext_m0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingModel(str(tmp_path), "recnext_m0")


def test_training_and_bench_entry_points_raise_without_a_gpu(no_gpu, tmp_path):
    from recnext_tpu_torch import bench
    from recnext_tpu_torch.tasks import train_det, train_seg
    from recnext_tpu_torch.train import main as train_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main.main(["--data-set", "FAKE", "--simple-aug", "--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_seg.main(["--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_det.main(["--detector", "retinanet", "--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_det.main(["--with-mask", "--output-dir", str(tmp_path)])
    for fn in (bench.throughput, bench.train_throughput):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn("recnext_m0", 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.latency_ms("recnext_m0")
