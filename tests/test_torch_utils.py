"""The port's utilities against the JAX package's: ``utils/metrics.py``
(``SmoothedValue``, ``MetricLogger`` on ``tests/test_metrics.py``'s sequences),
``utils/watchdog.py`` (``require_devices`` exits 17 on an init that hangs),
``utils/profiling.py`` (``trace``, ``annotate``, ``device_time``, ``Stopwatch`` on
the CPU), ``parallel/serving.py`` (``make_sharded_inference``: replicas in threads,
the logits in batch order) and ``parallel/sharding.py``'s helpers alone."""

import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from recnext_tpu.utils.metrics import MetricLogger as JaxMetricLogger
from recnext_tpu.utils.metrics import SmoothedValue as JaxSmoothedValue
from recnext_tpu_torch.models.registry import create_model
from recnext_tpu_torch.parallel import sharding
from recnext_tpu_torch.parallel.serving import make_sharded_inference
from recnext_tpu_torch.utils import profiling
from recnext_tpu_torch.utils.metrics import MetricLogger, SmoothedValue
from recnext_tpu_torch.utils.watchdog import EXIT_DEVICE_INIT_TIMEOUT

REPO = Path(__file__).resolve().parents[1]
OVR = dict(embed_dim=(16, 32, 64, 128), depth=(1, 1, 2, 1), num_classes=11)


@pytest.mark.parametrize("window", [3, 20])
def test_smoothed_value_is_jax_s(window):
    ours, theirs = SmoothedValue(window_size=window), JaxSmoothedValue(window_size=window)
    for x, n in ((1.0, 1), (2.0, 1), (3.0, 2), (4.0, 1), (-0.5, 3)):
        ours.update(x, n)
        theirs.update(x, n)
        for attr in ("value", "median", "avg", "global_avg", "count", "total"):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
        assert str(ours) == str(theirs)
    ours.synchronize_between_processes()  # one process: nothing moves
    assert (ours.count, ours.total) == (theirs.count, theirs.total)


def test_metric_logger_is_jax_s(capsys):
    loggers = (MetricLogger(), JaxMetricLogger())
    outs = []
    for ml in loggers:
        for i, _ in enumerate(ml.log_every(range(5), print_freq=2, header="t", total=5)):
            ml.update(loss=float(i), acc=2.0 * i)
        outs.append(capsys.readouterr().out)
    ours, theirs = loggers
    assert str(ours) == str(theirs) and ours.loss.global_avg == 2.0
    ours.synchronize_between_processes()
    for out in outs:
        assert "t [0/5]" in out and "t [4/5]" in out and "done in" in out
    # the same lines, but for the timings
    strip = [[line.split(" eta")[0] for line in out.splitlines()] for out in outs]
    assert strip[0][:-1] == strip[1][:-1]
    with pytest.raises(AttributeError):
        ours.missing


def test_require_devices_exits_17_on_a_hung_init():
    code = textwrap.dedent("""
        import time, torch
        from recnext_tpu_torch.utils import watchdog
        torch.cuda.is_available = lambda: True  # a GPU whose init never returns
        torch.cuda.init = lambda: time.sleep(60)
        watchdog.require_devices(0.5, metric="test_init")
        print("returned")
    """)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == EXIT_DEVICE_INIT_TIMEOUT == 17
    assert time.perf_counter() - t0 < 30 and "returned" not in proc.stdout
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "test_init" and rec["unit"] == "error" and rec["value"] is None


def test_require_devices_raises_without_a_gpu():
    from recnext_tpu_torch.utils.watchdog import require_devices

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        require_devices(1.0)


def test_trace_annotate_device_time_and_stopwatch_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("matmul_region"):
            (x @ x).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "matmul_region" in names and any("mm" in str(n) for n in names)
    ms = profiling.device_time(lambda a: a @ a, x, iters=5)
    assert 0 < ms < 1e3
    with profiling.Stopwatch() as sw:
        time.sleep(0.05)
    assert 0.04 < sw.elapsed < 5


def test_sharded_inference_splits_the_batch_and_keeps_its_order():
    model = create_model("recnext_m0", device="cpu", **OVR)
    x = torch.randn(6, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    infer = make_sharded_inference(model, model.state_dict(), devices=["cpu", "cpu", "cpu"])
    with torch.no_grad():
        want = model.eval()(x)
    got = infer(x)
    assert got.shape == (6, 11) and torch.allclose(got, want, atol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        infer(x[:5])
    one = make_sharded_inference("recnext_m0", model.state_dict(), devices=["cpu"], **OVR)
    assert torch.allclose(one(x), want, atol=1e-6)


def test_sharding_helpers_alone():
    assert sharding.world_size() == 1 and sharding.rank() == 0
    assert sharding.choose_backend("cuda", 2, 8) == "nccl"
    assert sharding.choose_backend("cuda", 2, 1) == "gloo"  # two ranks share one GPU
    assert sharding.choose_backend("cpu", 1, 0) == "gloo"
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(sharding.partner_rows(x), x.flip(0))
    assert sharding.all_reduce_gradients([torch.nn.Parameter(torch.ones(2))]) == 0
    assert not sharding.init_distributed(device_type="cpu")  # no coordinator: one process
    assert sharding.make_mesh(fsdp=1)["fsdp"] == 1
    with pytest.raises(NotImplementedError, match="item 17"):
        sharding.make_mesh(fsdp=2)
    with pytest.raises(NotImplementedError, match="item 17"):
        sharding.state_sharding({}, {"data": 1, "fsdp": 2})
