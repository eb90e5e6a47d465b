"""Where kernel K1 (``csrc/recconv.cu``) spends its time, on one GPU.

    python -m recnext_tpu_torch.tools.k1_phases

At recnext_m1's four mixer shapes (batch 256, bf16), times with CUDA events:

* ``phases``: the kernel as built, and builds of it with one phase compiled out
  each (weights, plane load, downsample, up-step convs, upsample, final conv, staged
  store); what a phase costs is the full time less the time without it. The
  variants compute wrong results and are only timed.
* ``teams``: the kernel as built with every team size that fits, in place of
  ``ops/cuda/recconv.py:team_size``'s choice.

Prints one JSON line per shape and the card's name and power limit. Builds go to a
temporary directory; nothing of the package is changed.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from recnext_tpu_torch.ops.cuda import build
from recnext_tpu_torch.ops.cuda import recconv as rc
from recnext_tpu_torch.ops.recconv import rec_conv2d_fused

M1_MIXERS = {4: (48, 56), 3: (96, 28), 2: (192, 14), 1: (384, 7)}  # level: (C, side)
# phase: (first line, the text it runs up to) in csrc/recconv.cu
PHASES = {
    "weights": ("    // the channel's weights, four loads", "    copy_async_wait();"),
    "load": ("    // this team's plane from the fetched chunks",
             "    __syncthreads();\n    // the next group's span"),
    "down": ("    // 1. downsample pyramid", "    // 2. walk back up"),
    "up_convs": ("      {\n        float wk[K * K], acc[kStrip];\n"
                 "        load_weights<K>(wk, wts + (1 + level - l)",
                 "      team_sync();\n\n      const int4* rows"),
    "upsample": ("      const int4* rows = splan", "      team_sync();\n    }\n\n    // 3. y ="),
    "final_conv": ("    {\n      float wk[K * K], acc[kStrip];\n"
                   "      load_weights<K>(wk, wts + (1 + level) * kTaps4<K>);",
                   "    __syncthreads();\n    if (direct) continue;"),
    "staged_store": ("    // 4. (odd W)", "\n  }\n}\n\ntemplate <typename T, int K>\ncudaError_t launch("),
}


def _without(src: str, phase: str) -> str:
    start, stop = PHASES[phase]
    a = src.index(start)
    return src[:a] + src[src.index(stop, a):]


def _build(sources: dict[str, str], out: Path) -> dict[str, ctypes.CDLL]:
    def one(item):
        name, text = item
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(text)
        subprocess.run([build._nvcc(rc.SOURCE), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        rc._declare(lib)
        return name, lib

    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per variant, together
        return dict(pool.map(one, sources.items()))


def _ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k1_phases: no CUDA device; this script runs on the GPU")
    src = rc.SOURCE.read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build({"full": src, **{p: _without(src, p) for p in PHASES}}, Path(tmp))
        gen = torch.Generator().manual_seed(0)
        chosen = rc.team_size
        try:
            for level, (c, side) in M1_MIXERS.items():
                x = torch.randn(256, c, side, side, generator=gen).to("cuda", torch.bfloat16)
                ws = [(torch.randn(c, 1, 5, 5, generator=gen) / 5).to("cuda", torch.bfloat16)
                      for _ in range(level + 2)]
                run = lambda: rec_conv2d_fused(x, ws[0], ws[1:], level=level)  # noqa: E731
                phases = {}
                for name, lib in libs.items():
                    rc.LIBRARY._lib = lib
                    phases[name] = _ms(run)
                rc.LIBRARY._lib = libs["full"]
                teams = {}
                for team in rc.TEAM_SIZES:
                    rc.team_size = lambda h, w, team=team: team
                    rc.launch_config.cache_clear()
                    try:
                        cfg = rc.launch_config(side, side, level, 5, 2)
                    except ValueError:
                        continue
                    if cfg.team == team:
                        teams[team] = _ms(run)
                rc.team_size = chosen
                rc.launch_config.cache_clear()
                print(json.dumps({"shape": [256, c, side, side], "level": level,
                                  "team": rc.launch_config(side, side, level, 5, 2).team,
                                  "phases_ms": phases, "teams_ms": teams}), flush=True)
        finally:
            rc.team_size = chosen
            rc.launch_config.cache_clear()
            rc.LIBRARY._lib = None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
