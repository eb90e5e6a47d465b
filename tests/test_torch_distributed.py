"""Two processes (gloo, on the CPU) train one model on the global batch, as JAX does
on a sharded batch under ``jit``: after 2 train steps of recnext_m0 (a small config,
fp32, mixup on; ``--remat`` in one case) the losses, the parameters and the BN
running statistics equal one process's on the global batch, and so do the eval
totals summed over the ranks. The cross-process BatchNorm Function's values and
gradients equal ``F.batch_norm`` on the concatenated batch. The trainer CLI runs as
two processes with ``--dist-*``.

The workers are this file run as a script (``python test_torch_distributed.py
worker ...``); each subprocess has a timeout."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
OVR = dict(embed_dim=(16, 32, 64, 128), depth=(1, 1, 2, 1), num_classes=11)
GLOBAL_BATCH, SIDE, STEPS = 8, 32, 2
LR = 1e-3
RTOL, ATOL = 1e-5, 1e-6
# AdamW moves an element by about lr * m / sqrt(v) a step whatever its gradient's size,
# so the parameters agree to 1% of one step's lr beside the rtol. Where a gradient is
# zero but for rounding (a BatchNorm's bias before a conv and another BatchNorm: the
# function does not depend on it), its last bits, summed over the ranks in another
# order, set the move's sign: such elements (|g| under NOISE of the step's largest)
# are held to the move's bound alone. The gradients agree to NOISE of the largest: fp32
# sums over N*H*W terms that cancel, taken over the ranks in another order
ATOL_PARAM = 1e-2 * LR
NOISE = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _batches():
    """The global batches of the 2 steps (numpy, seeded)."""
    rng = np.random.default_rng(0)
    img = rng.normal(size=(STEPS, GLOBAL_BATCH, 3, SIDE, SIDE)).astype(np.float32)
    lab = rng.integers(0, OVR["num_classes"], size=(STEPS, GLOBAL_BATCH))
    return torch.from_numpy(img), torch.from_numpy(lab)


def run_steps(remat: bool, rank: int = 0, world: int = 1) -> dict:
    """2 train steps of recnext_m0 on this rank's rows of the global batches: the
    losses, and after each step the reduced gradients, the state and the EMA."""
    from recnext_tpu_torch.models.registry import create_model
    from recnext_tpu_torch.train.optim import make_optimizer
    from recnext_tpu_torch.train.state import TrainState
    from recnext_tpu_torch.train.step import make_train_step

    torch.manual_seed(0)
    model = create_model("recnext_m0", device="cpu", generator=torch.Generator().manual_seed(0),
                         **OVR)
    opt = make_optimizer(model.named_parameters(), lambda s: LR, 0.025, 0.02)
    state = TrainState.create(model, opt)
    step = make_train_step(num_classes=OVR["num_classes"], dtype=torch.float32, remat=remat,
                           ema_decay=0.9)
    imgs, labs = _batches()
    b = GLOBAL_BATCH // world
    rows = slice(rank * b, (rank + 1) * b)
    losses, grads, states, emas = [], [], [], []
    for s in range(STEPS):
        gen = torch.Generator().manual_seed(s)
        m = step(state, {"image": imgs[s][rows], "label": labs[s][rows]}, gen)
        losses.append(float(m["loss"]))
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
        states.append({k: v.detach().clone() for k, v in model.state_dict().items()})
        emas.append({k: v.clone() for k, v in state.ema.items()})
    return {"losses": losses, "grads": grads, "states": states, "emas": emas}


def run_sync_bn(rank: int, world: int) -> dict:
    """The cross-process BatchNorm on this rank's rows of a (8, 6, 5, 4) batch: its
    output, and the gradients of sum(y * w_out)."""
    from recnext_tpu_torch.models.layers import _SyncBatchNorm

    rng = np.random.default_rng(1)
    x = torch.from_numpy(3 + 2 * rng.normal(size=(8, 6, 5, 4)).astype(np.float32))
    w_out = torch.from_numpy(rng.normal(size=(8, 6, 5, 4)).astype(np.float32))
    weight = torch.from_numpy(1 + 0.1 * rng.normal(size=6).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.normal(size=6).astype(np.float32))
    b = 8 // world
    xs = x[rank * b:(rank + 1) * b].clone().requires_grad_()
    w, bb = weight.clone().requires_grad_(), bias.clone().requires_grad_()
    rm, rv = torch.zeros(6), torch.ones(6)
    y = _SyncBatchNorm.apply(xs, w, bb, rm, rv, 0.1, 1e-5, True)
    (y * w_out[rank * b:(rank + 1) * b]).sum().backward()
    return {"y": y.detach(), "dx": xs.grad, "dw": w.grad, "db": bb.grad, "rm": rm, "rv": rv}


def worker(rank: int, world: int, port: int, out: str, what: str) -> None:
    from recnext_tpu_torch.parallel.sharding import init_distributed

    torch.set_num_threads(1)
    coordinator = f"127.0.0.1:{port}"
    if what != "steps":  # the trainer CLI, which joins the group itself
        from recnext_tpu_torch.train import main as train_main

        argv = json.loads(what) + ["--dist-coordinator", coordinator, "--dist-num-processes",
                                   str(world), "--dist-process-id", str(rank)]
        res = train_main.main(argv)
        torch.save(res["state"].model.state_dict() if "state" in res else res, out)
        return
    assert init_distributed(coordinator, world, rank, device_type="cpu", log=lambda m: None)
    try:
        torch.save({"plain": run_steps(False, rank, world), "remat": run_steps(True, rank, world),
                    "bn": run_sync_bn(rank, world)}, out)
    finally:
        torch.distributed.destroy_process_group()


def _spawn(tmp_path, what: str, world: int = 2):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, "worker", str(r), str(world),
                               str(port), str(tmp_path / f"rank{r}.pt"), what],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)], outs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("dist"), "steps")[0]


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=atol,
                               err_msg=what)


def _check_param(got, want, noise, what):
    """Within the rtol (and 1% of lr) where the gradient is the signal; within the
    moves' bound, 2 * lr * STEPS, where it is rounding noise."""
    _close(got[~noise], want[~noise], what, ATOL_PARAM)
    assert ((got - want).abs()[noise] <= 2 * LR * STEPS).all(), what


@pytest.mark.parametrize("case", ["plain", "remat"])
def test_two_processes_train_as_one_on_the_global_batch(two_ranks, case):
    torch.set_num_threads(1)
    one = run_steps(case == "remat")
    noise = {}
    for s, g in enumerate(one["grads"]):
        gmax = max(t.abs().max().item() for t in g.values())
        for k, t in g.items():
            noise[k] = noise.get(k, False) | (t.abs() < NOISE * gmax)
            for r, res in enumerate(two_ranks):  # the reduced gradient is the global one
                _close(res[case]["grads"][s][k], t, f"rank {r} step {s} grad {k}",
                       NOISE * gmax)
    for r, res in enumerate(two_ranks):
        got = res[case]
        _close(got["losses"], one["losses"], f"rank {r} losses")
        for s in range(STEPS):
            for k, v in one["states"][s].items():
                what = f"rank {r} step {s} {k}"
                if not v.is_floating_point():
                    assert torch.equal(got["states"][s][k], v), what
                elif k in noise:
                    _check_param(got["states"][s][k], v, noise[k], what)
                    _check_param(got["emas"][s][k], one["emas"][s][k], noise[k], what)
                elif s == 0:  # the BN statistics of the first step's forward
                    _close(got["states"][s][k], v, what)
                    _close(got["emas"][s][k], one["emas"][s][k], what)
                elif k.endswith("running_var"):
                    # the second step's forward ran on parameters that agree to 1% of
                    # lr, so its statistics agree to 1e-4; its running means also follow
                    # the shift of their input along a noise-moved bias, which leaves
                    # the variance (and the train-mode function) as it is
                    np.testing.assert_allclose(got["states"][s][k], v, rtol=1e-4, err_msg=what)
    # the running statistics moved (both steps were in train mode)
    var = one["states"][-1]["stem.stem.0.norm.running_var"]
    assert not torch.equal(var, torch.ones_like(var))


def test_cross_process_batch_norm_is_batch_norm_on_the_whole_batch(two_ranks):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(3 + 2 * rng.normal(size=(8, 6, 5, 4)).astype(np.float32))
    w_out = torch.from_numpy(rng.normal(size=(8, 6, 5, 4)).astype(np.float32))
    weight = torch.from_numpy(1 + 0.1 * rng.normal(size=6).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.normal(size=6).astype(np.float32))
    xs, w, b = x.clone().requires_grad_(), weight.clone().requires_grad_(), \
        bias.clone().requires_grad_()
    rm, rv = torch.zeros(6), torch.ones(6)
    y = F.batch_norm(xs, rm, rv, w, b, True, 0.1, 1e-5)
    (y * w_out).sum().backward()
    ranks = [res["bn"] for res in two_ranks]
    _close(torch.cat([r["y"] for r in ranks]), y.detach(), "y")
    _close(torch.cat([r["dx"] for r in ranks]), xs.grad, "dx")
    # each rank's affine gradient is its rows' share: the step's all-reduce sums them
    _close(sum(r["dw"] for r in ranks), w.grad, "dw")
    _close(sum(r["db"] for r in ranks), b.grad, "db")
    for r in ranks:
        _close(r["rm"], rm, "running_mean")
        _close(r["rv"], rv, "running_var")


def test_trainer_cli_runs_as_two_processes(tmp_path):
    """One epoch as two processes; then --eval of its checkpoint as two processes
    (each scores its strided share of the split, the totals summed over the ranks)
    against one process on the whole split."""
    from recnext_tpu_torch.train import main as train_main

    out = tmp_path / "run"
    argv = ["--device", "cpu", "--model", "recnext_m0", "--model-kwargs",
            "embed_dim=16:32:64:128,depth=1:1:2:1", "--data-set", "FAKE", "--simple-aug",
            "--input-size", "32", "--batch-size", "8", "--epochs", "1", "--steps-per-epoch",
            "2", "--fake-classes", "11", "--dtype", "float32", "--log-every", "1",
            "--output-dir", str(out)]
    (rank0, rank1), logs = _spawn(tmp_path, json.dumps(argv))
    assert all(torch.equal(rank0[k], rank1[k]) for k in rank0)  # one model, two replicas
    assert "backend gloo" in logs[0] and "epoch 0 step 2" in logs[0]
    assert "epoch 0 step" not in logs[1]  # only rank 0 logs
    stats = [json.loads(line) for line in (out / "log.txt").read_text().splitlines()]
    assert len(stats) == 1 and np.isfinite(stats[0]["train_loss"])
    assert (out / "ckpt" / "epoch_0000.pt").exists()
    evals, _ = _spawn(tmp_path, json.dumps(argv + ["--eval", "--batch-size", "16"]))
    torch.set_num_threads(1)
    one = train_main.main(argv + ["--eval", "--batch-size", "16"])
    for res in evals:
        for k in ("acc1", "acc5", "test_loss"):
            _close(res[k], one[k], k)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
