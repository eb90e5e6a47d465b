"""The eager fused bf16 forward of recnext_m1 and recnext_a1 (BN statistics of one
random batch, through the kernels) at batch 1 and 256, from two source trees in turns
on one card: a change against its parent.

    git archive <parent> | tar -x -C runs/parent
    python recnext_tpu_torch/tools/eager_latency.py runs/parent .

runs the trees as parent, change, change, parent, change, parent, each in a process of
its own that imports ``recnext_tpu_torch`` from its tree (and builds its kernels there),
and prints one JSON line a run: the median over 5 windows of CUDA events around 200
(batch 1) or 20 (batch 256) forwards after 10 of warm-up. Batch 1 is host-bound: its
spread between runs of one tree says how far apart two trees must be to differ.
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

ORDER = (0, 1, 1, 0, 1, 0)  # parent, change, change, parent, change, parent


def _calibrated(create_model, name):
    import torch

    gen = torch.Generator().manual_seed(1)
    model = create_model(name, device="cuda", generator=gen)
    for bn in model.modules():
        if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
            bn.reset_running_stats()
            bn.momentum = None
    with torch.no_grad():
        model.train()(torch.randn(32, 3, 224, 224, generator=gen).cuda())
    return model.eval()


def _ms(fn, iters):
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(5):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / iters)
    return statistics.median(out)


def one(tree):
    """One run: the forwards of the ``recnext_tpu_torch`` found in ``tree``."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from recnext_tpu_torch.fusion import fuse_params
    from recnext_tpu_torch.models.registry import create_model

    rec = {"tree": tree}
    for name in ("recnext_m1", "recnext_a1"):
        fused = create_model(name, fused=True, device="cuda", dtype=torch.bfloat16)
        fused.load_state_dict(fuse_params(_calibrated(create_model, name).state_dict()))
        x = torch.randn(256, 3, 224, 224).to("cuda", torch.bfloat16)
        with torch.inference_mode():
            rec[name] = {"batch_1_ms": _ms(lambda: fused(x[:1]), 200),
                         "batch_256_ms": _ms(lambda: fused(x), 20)}
    print(json.dumps(rec), flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        return one(argv[1])
    parent, change = argv
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for i in ORDER:
        subprocess.run([sys.executable, __file__, "--one", (parent, change)[i]], check=True)


if __name__ == "__main__":
    main()
