"""Where the RecConv2d backward kernel K1' (``csrc/recconv_bwd.cu``) spends its
time, on one GPU.

    python -m recnext_tpu_torch.tools.k1_bwd_phases

At recnext_m1's four training shapes (batch 128, bf16, bilinear, k = 5), device
times per call from a torch.profiler trace (every kernel of the call: the weights'
stack, the backward kernel and the sum over the batch):

* ``phases_ms``: the kernel as built, and builds of it with one phase compiled out
  each; the source marks a phase's code between a ``// phase NAME`` line and an
  ``// end NAME`` line (a name may mark several places). What a phase costs is the
  full time less the time without it. The weight-gradient sums are replaced by a
  cheap use of the partial sums, so that the compiler keeps the correlations that
  feed them. The variants compute wrong results and are only timed.
* ``teams_ms``: the kernel as built with every team size (threads per plane) that
  fits, in place of ``ops/cuda/recconv_bwd.py:team_size``'s choice.
* ``sass``: the instruction mix of the bf16 k = 5 kernel as built (``cuobjdump
  -sass``): shared loads and stores, fp32 multiply-adds, shuffles, barriers.

Prints one JSON line per shape and the card's name and power limit. Builds go to a
temporary directory; nothing of the package is changed.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from recnext_tpu_torch.ops.cuda import build
from recnext_tpu_torch.ops.cuda import recconv_bwd as bwd
from recnext_tpu_torch.ops.cuda.recconv import TEAM_SIZES
from recnext_tpu_torch.ops.recconv import rec_conv2d_backward

M1_MIXERS = {4: (48, 56), 3: (96, 28), 2: (192, 14), 1: (384, 7)}  # level: (C, side)
BATCH = 128
PHASES = ("load", "pyramid", "h", "corr", "convt", "upt", "sums", "sweep2", "batch_sum")
# what stands in for a phase where leaving it out would let the compiler drop more
REPLACE = {"sums": ("  float s = 0.f;\n#pragma unroll\n  for (int t = 0; t < K * K; ++t) "
                    "s += acc[t];\n  if (s == 1234.5f) out[threadIdx.x % (K * K)] = s;\n")}
SASS_OPS = ("LDS", "STS", "FFMA", "SHFL", "BAR", "LDG", "STG")


def _without(src: str, phase: str) -> str:
    """``src`` with every region marked as ``phase`` replaced."""
    pattern = re.compile(rf"^[ \t]*// phase {phase}\b.*?^[ \t]*// end {phase}\n",
                         re.S | re.M)
    out, n = pattern.subn(REPLACE.get(phase, "").replace("\\", "\\\\"), src)
    if n == 0:
        raise ValueError(f"k1_bwd_phases: no region marked '{phase}' in {bwd.SOURCE}")
    return out


def _build(sources: dict[str, str], out: Path) -> dict[str, tuple[ctypes.CDLL, Path]]:
    def one(item):
        name, text = item
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(text)
        subprocess.run([build._nvcc(bwd.SOURCE), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        bwd._declare(lib)
        return name, (lib, so)

    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per variant, together
        return dict(pool.map(one, sources.items()))


def _sass(so: Path) -> dict | None:
    """Opcode counts of the bf16 k = 5 backward kernel in the library ``so``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True).stdout
    counts, inside = Counter(), False
    for line in text.splitlines():
        if "Function :" in line:
            inside = "recconv_bwd_kernel" in line and "bfloat16Li5E" in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1)] += 1
    if not counts:
        return None
    return {"instructions": sum(counts.values()), **{op: counts[op] for op in SASS_OPS}}


def _device_ms(fn, iters: int = 10) -> float:
    """Device time per call: the kernels' times summed over ``iters`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation)
        if total > 0:
            return total / 1e3 / iters
    raise RuntimeError("k1_bwd_phases: the profiler saw no device time")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k1_bwd_phases: no CUDA device; this script runs on the GPU")
    src = bwd.SOURCE.read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build({"full": src, **{p: _without(src, p) for p in PHASES}}, Path(tmp))
        sass = _sass(libs["full"][1])
        gen = torch.Generator().manual_seed(0)
        chosen = bwd.team_size
        try:
            for level, (c, side) in M1_MIXERS.items():
                x = torch.randn(BATCH, c, side, side, generator=gen).to("cuda", torch.bfloat16)
                g = torch.randn(BATCH, c, side, side, generator=gen).to("cuda", torch.bfloat16)
                ws = [(torch.randn(c, 1, 5, 5, generator=gen) / 5).to("cuda", torch.bfloat16)
                      for _ in range(level + 2)]
                run = lambda: rec_conv2d_backward(x, ws[0], ws[1:], g, level=level)  # noqa: E731
                phases = {}
                for name, (lib, _) in libs.items():
                    bwd.LIBRARY._lib = lib
                    phases[name] = _device_ms(run)
                bwd.LIBRARY._lib = libs["full"][0]
                teams = {}
                for team in TEAM_SIZES:
                    bwd.team_size = lambda h, w, team=team: team
                    bwd.launch_config.cache_clear()
                    try:
                        cfg = bwd.launch_config(side, side, level, 5)
                    except ValueError:
                        continue
                    if cfg.team == team:
                        teams[team] = _device_ms(run)
                bwd.team_size = chosen
                bwd.launch_config.cache_clear()
                cfg = bwd.launch_config(side, side, level, 5)
                print(json.dumps({
                    "shape": [BATCH, c, side, side], "level": level, "team": cfg.team,
                    "planes_per_block": cfg.planes_per_block, "smem_bytes": cfg.smem_bytes,
                    "resident_blocks": bwd.resident_blocks(side, side, level, 5,
                                                           torch.bfloat16),
                    "phases_ms": phases, "teams_ms": teams, "sass_bf16_k5": sass}), flush=True)
        finally:
            bwd.team_size = chosen
            bwd.launch_config.cache_clear()
            bwd.LIBRARY._lib = None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
