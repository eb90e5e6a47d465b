"""The port's measurement tools (``recnext_tpu_torch/tools/``) against the JAX package's
(``recnext_tpu/benchmark/``), on the CPU.

The op counter against ``analyze_jaxpr``: fused m0, a0 and recnext_t at 224² and
mlla_nano at 256², batch 1; dense and depthwise MACs within 0.5% of JAX's ``mxu_macs``
and ``vpu_macs``, elementwise ops within 10% (the port counts a composite aten op by
the elementwise ops of its JAX decomposition, ``tools/roofline.py:_COMPOSITE``; the
rest is the fused model's kept BatchNorm and where each side adds a residual).
JAX's M and A models are taken in their gather-upsample and head-batched forms
(``recconv_upsample="gather"``, ``attn_impl="headbatch"``), the JAX package's own
forms of the same functions that the port runs: its defaults, a bilinear resize as
interpolation matrices and the attention as one masked C x C product, are TPU layouts
that count other MACs for the same result. The train step's MACs against JAX's at m0,
64², batch 2, within 0.5%, once JAX's filter gradient of a conv with one input
channel a group is read on the CUDA cores as the port reads it (``_jax_conv_macs``;
JAX's ``_conv_macs`` reads it as dense once the batch exceeds 1); its elementwise ops
within 35% (the optimizer's AGC and the BatchNorm backward decompose differently).
Parameter counts equal JAX's, fused and unfused. Then the roofline share from
``--results``, ``merge_results``, ``bench_all``'s resume and error rows with a stubbed
bench, the ``occupancy_scan`` climb against a stubbed throughput, ``analyze_logs``
over the port trainer's log and the JAX package's, the model cards,
``flops_attn``'s crossover against JAX's ``analyze``, ``profile_attn.similarity``
against JAX's, and ``stage_breakdown``'s sections, which equal the fused forward bit
for bit. The JAX side's traces run in spawned processes, beside the port's counts."""

import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from recnext_tpu_torch.tools import (analyze_logs, bench_all, flops, merge_results,
                                     modelcard, occupancy_scan, profile_attn, roofline,
                                     stage_breakdown)

REPO = Path(__file__).resolve().parents[1]
FORWARDS = {"recnext_m0": 224, "recnext_a0": 224, "recnext_t": 224, "mlla_nano_recconv": 256}
JAX_FORMS = dict(recconv_upsample="gather", attn_impl="headbatch")


def _jax_forward(name: str, size: int) -> dict:
    """JAX's counts of the deployed forward at batch 1, and its parameter counts."""
    import jax
    import jax.numpy as jnp

    from recnext_tpu.benchmark.roofline import analyze_jaxpr

    x0 = jnp.zeros((1, size, size, 3), jnp.bfloat16)
    if name.startswith("mlla"):
        from recnext_tpu.models.mlla import create_mlla

        infer = create_mlla(name, dtype=jnp.bfloat16)
        shapes = jax.eval_shape(infer.init, jax.random.PRNGKey(0), x0)
        fv = jax.tree.map(lambda s: np.ones(s.shape, s.dtype), shapes)
        params = {"fused": None, "unfused": _count(fv["params"])}
    else:
        from recnext_tpu.fusion import fuse_params
        from recnext_tpu.models.registry import create_model

        model = create_model(name, dtype=jnp.bfloat16, **JAX_FORMS)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x0)
        variables = jax.tree.map(lambda s: np.ones(s.shape, s.dtype), shapes)
        fv = fuse_params(variables)
        infer = create_model(name, fused=True, dtype=jnp.bfloat16, **JAX_FORMS)
        params = {"fused": _count(fv["params"]), "unfused": _count(variables["params"])}
    jaxpr = jax.make_jaxpr(lambda v, xx: infer.apply(v, xx, training=False))(fv, x0)
    return {**analyze_jaxpr(jaxpr), "params": params}


def _count(tree) -> int:
    import jax

    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(tree))


def _jax_conv_macs(eqn):
    """JAX's ``_conv_macs`` with a filter gradient (a batch-grouped conv) on the CUDA
    cores where its forward had one input channel a group: its lhs is the forward's
    input with the channels as the batch, batch_group_count of them a group."""
    from recnext_tpu.benchmark import roofline as R

    macs, dw = R.__dict__["_jax_orig_conv_macs"](eqn)
    bg = eqn.params.get("batch_group_count", 1)
    lhs = eqn.invars[0].aval.shape
    cin = lhs[eqn.params["dimension_numbers"].lhs_spec[0]]
    return macs, dw or (bg > 1 and cin == bg)


def _jax_train(name: str, size: int, batch: int) -> dict:
    """JAX's counts of ``train_roofline``'s step (mixup, forward, backward, AdamW + AGC,
    EMA) in the forms above, with ``_jax_conv_macs``."""
    import jax
    import jax.numpy as jnp

    from recnext_tpu.benchmark import roofline as R
    from recnext_tpu.models.registry import create_model
    from recnext_tpu.train.optim import cosine_schedule, make_optimizer
    from recnext_tpu.train.state import TrainState
    from recnext_tpu.train.step import make_train_step

    model = create_model(name, dtype=jnp.bfloat16, **JAX_FORMS)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.bfloat16))
    variables = jax.tree.map(lambda s: np.ones(s.shape, s.dtype), shapes)
    tx = make_optimizer(cosine_schedule(1e-3, 1000))
    step = make_train_step(model, tx, num_classes=1000, mixup=True)
    data = {"image": jnp.zeros((batch, size, size, 3), jnp.bfloat16),
            "label": jnp.zeros((batch,), jnp.int32)}
    jaxpr = jax.make_jaxpr(step)(TrainState.create(variables, tx), data, jax.random.PRNGKey(0))
    R._jax_orig_conv_macs = R._conv_macs
    R._conv_macs = _jax_conv_macs
    return R.analyze_jaxpr(jaxpr)


def _jax_attn_crossover():
    from recnext_tpu.benchmark.flops_attn import COMBOS, analyze

    return [analyze(*c)["kv_first_cheaper"] for c in COMBOS]


def _call(fn, *args):
    return fn(*args)


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX reference of the file, each in a spawned process of its own, started
    first so that they trace while the port counts."""
    ctx = multiprocessing.get_context("spawn")
    jobs = {name: (_jax_forward, name, size) for name, size in FORWARDS.items()}
    jobs["train"] = (_jax_train, "recnext_m0", 64, 2)
    jobs["attn"] = (_jax_attn_crossover,)
    pool = ProcessPoolExecutor(len(jobs), mp_context=ctx)
    futures = {k: pool.submit(_call, *job) for k, job in jobs.items()}
    yield futures
    pool.shutdown()


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_counter_matches_analyze_jaxpr(name, jax_refs):
    got = flops.forward_counts(name, FORWARDS[name])
    want = jax_refs[name].result()
    assert got["dense_macs"] == pytest.approx(want["mxu_macs"], rel=5e-3)
    assert got["depthwise_macs"] == pytest.approx(want["vpu_macs"], rel=5e-3)
    assert got["elementwise_ops"] == pytest.approx(want["vpu_elementwise_ops"], rel=0.10)
    # fvcore's MACs: the conv and matmul multiply-adds
    assert flops.model_flops(name, FORWARDS[name])[1] == got["dense_macs"] + got["depthwise_macs"]


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_parameter_counts_equal_jax(name, jax_refs):
    want = jax_refs[name].result()["params"]
    if name.startswith("mlla"):
        assert flops.mlla_flops(name)[0] == want["unfused"]
        return
    assert flops.count_params(flops.build_model(name, fused=False)) == want["unfused"]
    assert flops.model_flops(name, 224)[0] == want["fused"]


def test_train_step_macs_match_jax(jax_refs):
    row = roofline.train_roofline("recnext_m0", image_size=64, batch=2)
    want = jax_refs["train"].result()
    assert row["train_tensor_gmacs_per_img"] * 2e9 == pytest.approx(want["mxu_macs"], rel=5e-3)
    assert row["train_cuda_core_gmacs_per_img"] * 2e9 == pytest.approx(want["vpu_macs"],
                                                                         rel=5e-3)
    assert (row["train_cuda_core_gops_elementwise_per_img"] * 2e9
            == pytest.approx(want["vpu_elementwise_ops"], rel=0.35))
    assert row["bwd_over_fwd_macs"] > 1.5


def test_roofline_share_from_results(tmp_path, capsys):
    res = tmp_path / "res.json"
    res.write_text(json.dumps([{"model": "recnext_m0", "images_per_sec": 20000.0,
                                "batch": 256, "device": "NVIDIA H100 80GB HBM3, 700.00 W"}]))
    rows = roofline.main(["--results", str(res), "--out", str(tmp_path / "r.json")])
    (row,) = rows
    assert row["measured_ms_per_img"] == pytest.approx(1e3 / 20000.0)
    bound = max(row["tensor_bound_ms"], row["cuda_core_bound_ms"], row["hbm_bound_ms"])
    assert row["bound_ms_per_img"] == bound
    assert row["roofline_utilization_pct"] == pytest.approx(100 * bound / row["measured_ms_per_img"])
    assert 0 < row["roofline_utilization_pct"] <= 100
    assert row["bound_engine"] in ("tensor", "cuda_core", "hbm")
    assert row["bound_ms_at_batch"] == pytest.approx(256 * bound)
    assert row["measured_on"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads((tmp_path / "r.json").read_text()) == rows
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == row


def test_merge_results_best_of_batch(tmp_path):
    a = [{"model": "recnext_m0", "images_per_sec": 14000.0, "batch": 256, "latency_ms": 0.21,
          "device": "H100"},
         {"model": "recnext_m1", "images_per_sec": 9400.0, "batch": 256, "device": "H100"}]
    b = [{"model": "recnext_m0", "images_per_sec": 14800.0, "batch": 512, "device": "H100"},
         {"model": "recnext_m1", "images_per_sec": 9000.0, "batch": 512, "latency_ms": 0.3},
         {"model": "recnext_a0", "error": "RuntimeError: boom"}]
    (tmp_path / "a.json").write_text(json.dumps(a))
    (tmp_path / "b.json").write_text(json.dumps(b))
    out = tmp_path / "m.json"
    rows = merge_results.main([str(tmp_path / "a.json"), str(tmp_path / "b.json"),
                               "--out", str(out), "--markdown"])
    assert [r["model"] for r in rows] == ["recnext_m0", "recnext_m1"]
    assert rows[0]["batch"] == 512 and rows[0]["latency_ms"] == 0.21
    assert rows[1]["batch"] == 256 and rows[1]["latency_ms"] == 0.3
    assert json.loads(out.read_text()) == rows
    table = merge_results.markdown_table(rows)
    assert "| recnext_m0 | 14800 | 512 | H100 |" in table and "batch-1 ms" in table


def test_bench_all_resume_and_error_rows(tmp_path, monkeypatch):
    from recnext_tpu_torch import bench as bench_mod

    calls = []

    def fake_throughput(name, batch, **kw):
        calls.append(name)
        if name == "recnext_m1":
            raise RuntimeError("simulated launch failure")
        return 1000.0

    monkeypatch.setattr(bench_mod, "throughput", fake_throughput)
    monkeypatch.setattr(bench_mod, "latency_ms", lambda name, **kw: 1.5)
    out = tmp_path / "res.json"
    rows = bench_all.main(["--models", "recnext_m0", "recnext_m1", "--latency", "--device",
                           "cpu", "--stamp", "t", "--out", str(out)])
    assert [r["model"] for r in rows] == ["recnext_m0", "recnext_m1"]
    assert rows[0]["latency_ms"] == 1.5 and rows[0]["stamp"] == "t"
    assert rows[0]["vs_baseline"] == pytest.approx(1000.0 / 750)
    assert rows[1]["error"] == "RuntimeError: simulated launch failure"
    assert json.loads(out.read_text()) == rows

    monkeypatch.setattr(bench_mod, "throughput",
                        lambda name, batch, **kw: calls.append(name) or 2000.0)
    calls.clear()
    rows2 = bench_all.main(["--models", "recnext_m0", "recnext_m1", "--resume", "--device",
                            "cpu", "--out", str(out)])
    assert calls == ["recnext_m1"]
    assert {r["model"] for r in rows2} == {"recnext_m0", "recnext_m1"}
    assert all("error" not in r for r in rows2)
    calls.clear()
    rows3 = bench_all.main(["--models", "recnext_m0", "--resume", "--device", "cpu",
                            "--out", str(out)])
    assert calls == [] and rows3 == rows2
    # the default output is git-ignored, never a file of the repository
    assert bench_all.DEFAULT_OUT.startswith("runs/")


def test_occupancy_climb_stops_past_the_knee_and_at_out_of_memory():
    ips = {256: 100.0, 512: 150.0, 1024: 149.0, 2048: 120.0, 4096: 500.0}
    measured = []

    def measure(batch):
        measured.append(batch)
        return ips[batch]

    rows = occupancy_scan.climb("m", [256, 512, 1024, 2048, 4096], measure, tol=0.01)
    assert measured == [256, 512, 1024, 2048]  # 1024 within tol, 2048 past the knee
    assert [r["images_per_sec"] for r in rows] == [100.0, 150.0, 149.0, 120.0]
    # a starting row covers its batch and below
    measured.clear()
    occupancy_scan.climb("m", [256, 512, 1024, 2048], measure, best=140.0, best_batch=512)
    assert measured == [1024, 2048]

    def oom(batch):
        if batch >= 1024:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return ips[batch]

    rows = occupancy_scan.climb("m", [256, 512, 1024, 2048], oom)
    assert [r["batch_requested"] for r in rows] == [256, 512, 1024]
    assert rows[-1]["out_of_memory"] and "out of memory" in rows[-1]["error"]


def test_analyze_logs_reads_the_port_trainer_and_the_jax_package(tmp_path, capsys):
    from recnext_tpu_torch.train import main as train_main

    out = tmp_path / "run"
    train_main.main(["--device", "cpu", "--model", "recnext_m0", "--model-kwargs",
                     "embed_dim=8:16:32:64,depth=1:1:1:1", "--data-set", "FAKE",
                     "--simple-aug", "--input-size", "32", "--batch-size", "4", "--epochs",
                     "2", "--steps-per-epoch", "1", "--fake-classes", "5", "--dtype",
                     "float32", "--output-dir", str(out)])
    port_log = str(out / "log.txt")
    recs = analyze_logs.load_records(port_log)
    assert [r["epoch"] for r in recs] == [0, 1]
    (t,) = analyze_logs.main(["cal_train_time", port_log])
    assert t["records"] == 2
    assert t["time_mean_s"] == pytest.approx(sum(r["train_s"] for r in recs) / 2)
    assert t["images_per_sec_mean"] == pytest.approx(
        sum(r["train_images_per_sec"] for r in recs) / 2)
    jax_log = str(REPO / "examples/logs/fake100_m0_tpu_smoke.log")
    jrecs = analyze_logs.load_records(jax_log)
    (j,) = analyze_logs.main(["cal_train_time", jax_log])
    times = sorted(r["epoch_time_s"] for r in jrecs)
    assert j["records"] == len(jrecs) and j["time_max_s"] == times[-1]
    (s,) = analyze_logs.main(["cal_train_time", str(REPO / "examples/logs/fake_seg_semfpn_m0_tpu.log")])
    assert s["time_min_s"] > 0  # iter-keyed: differences of elapsed_s
    (b,) = analyze_logs.main(["best", jax_log, "--keys", "test_acc1"])
    assert b["best"] == max(r["test_acc1"] for r in jrecs)
    assert b["at"] == max((r["test_acc1"], r["epoch"]) for r in jrecs)[1]


def test_model_cards_carry_the_counts_and_the_card(tmp_path):
    card = modelcard.make_card("recnext_m0", measured={
        "model": "recnext_m0", "images_per_sec": 20000.0, "batch": 256, "image_size": 224,
        "vs_baseline": 26.7, "latency_ms": 7.7, "device": "NVIDIA H100 80GB HBM3, 700.00 W"})
    n, macs = flops.model_flops("recnext_m0", 224)
    assert f"| params (fused) | {n / 1e6:.2f} M |" in card
    assert f"| MACs @224 (fused) | {macs / 1e9:.3f} G |" in card
    assert "20000 img/s" in card and "NVIDIA H100 80GB HBM3, 700.00 W" in card
    assert "26.7x" in card and "7.70 ms" in card
    mcard = modelcard.make_mlla_card("mlla_nano_recconv")
    n, macs = flops.mlla_flops("mlla_nano_recconv")
    assert f"| params | {n / 1e6:.2f} M |" in mcard and f"{macs / 1e9:.3f} G" in mcard
    modelcard.main(["--model", "recnext_m0", "--out", str(tmp_path)])
    assert (tmp_path / "recnext_m0.md").read_text() == modelcard.make_card("recnext_m0")


def test_flops_attn_crossover_matches_jax(jax_refs):
    from recnext_tpu_torch.tools import flops_attn

    recs = flops_attn.main([])
    assert [r["kv_first_cheaper"] for r in recs] == jax_refs["attn"].result()
    assert all(r["crossover_ok"] and r["allclose_1e-4"] for r in recs)


def test_profile_attn_similarity_matches_jax():
    from recnext_tpu.benchmark.profile_attn import similarity as jax_similarity

    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 16, 8)).astype(np.float32)
    b = a + 1e-3 * rng.normal(size=a.shape).astype(np.float32)
    assert profile_attn.similarity(a, b) == jax_similarity(a, b)
    assert profile_attn.similarity(a, a)["allclose_1e-3"]


@pytest.mark.parametrize("name", ["recnext_m0", "recnext_a0", "recnext_t"])
def test_stage_sections_equal_the_fused_forward(name):
    model = flops.build_model(name)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        outs = stage_breakdown.sections_forward(model, x)
        want = model(x)
    assert [n for n, _ in stage_breakdown.sections(model)] == [
        "stem", "stage0", "stage1", "stage2", "stage3", "head"]
    assert torch.equal(outs[-1], want)


def test_timing_tools_run_on_the_cpu_when_asked():
    from recnext_tpu_torch.tools import bwd_micro, micro

    (row,) = [r for r in micro.bench_dwconv(batch=1, dtype=torch.float32, device="cpu", iters=1)
              if r["stride"] == 2]
    assert row["taps_ms"] > 0 and row["bound_ms"] > 0 and "winograd_f2_ms" not in row
    checks = micro.check_dwconv("cpu", batch=1)
    assert all(c["ok"] for c in checks), checks
    assert all(c["ok"] for c in bwd_micro.check_dw_grads("cpu", batch=1))
