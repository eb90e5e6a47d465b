"""Where kernel K2 (``csrc/linear_attention.cu``) spends its time, on one GPU.

    python -m recnext_tpu_torch.tools.k2_phases            # recnext_a1's shapes
    python -m recnext_tpu_torch.tools.k2_phases --shapes l  # the L family's

At recnext_a1's four attention shapes, or at the L family's seven (one head per
image; LA3's v a channel slice of the block's input), batch 256, bf16, the model's
NCHW entry, device times from a torch.profiler trace (ms per launch; CUDA events
would also count the host's time between launches, which bounds the small shapes):

* ``phases``: the kernel as built, and builds of it with one part taken out each
  (the cp.async copies, pass 1's work, its shuffle sums, pass 2's work, its
  stores); what a part costs is the full time less the time without it. The
  variants compute wrong results and are only timed.
* ``teams``: the kernel as built with every team size that fits, in place of
  ``ops/cuda/linear_attention.py:team_size``'s choice;
* ``block_share``: the kernel with a block's share of shared memory at a half and
  at twice ``BLOCK_SMEM_BYTES`` (which sets the heads per block and the tiles);
* ``plain``: the plain version's time (``linear_attention_nchw_plain``), beside.

Prints the registers and spills of each build, one JSON line per shape and the
card's name and power limit. Builds go to a temporary directory; nothing of the
package is changed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from recnext_tpu_torch.ops.attention import linear_attention_nchw, linear_attention_nchw_plain
from recnext_tpu_torch.ops.cuda import build
from recnext_tpu_torch.ops.cuda import linear_attention as la

# (heads, side, D, DV, variant, channels whose first heads*DV are v; 0: v its own)
A1 = {f"a1_stage{st}": (nh, side, 24, 24, 2 if st == 3 else 1, 0)
      for st, (nh, side) in enumerate(((2, 28), (4, 14), (8, 7), (16, 4)))}
L = {"l_n49_d32": (1, 7, 32, 32, 2, 0), "l_n16_d64": (1, 4, 64, 64, 2, 0),
     "l_n16_d64_dv128_la3": (1, 4, 64, 128, 2, 512), "l_n196_d32": (1, 14, 32, 32, 1, 0),
     "l_n49_d64": (1, 7, 64, 64, 2, 0), "l_n16_d96": (1, 4, 96, 96, 2, 0),
     "l_n49_d32_dv64_la3": (1, 7, 32, 64, 2, 256)}
# part: (text in csrc/linear_attention.cu, the text that takes it out)
PARTS = {
    "copies": ("                                           int n0, int len, const Geometry& g, "
               "int tid) {\n",
               "                                           int n0, int len, const Geometry& g, "
               "int tid) {\n  if (g.n > 0) return;\n"),
    "pass1": ("    for (int it = tid; it < items; it += T_) {",
              "    for (int it = tid; it < 0 * items; it += T_) {"),
    "shuffles": ("      for (int off = g.splits >> 1; off > 0; off >>= 1) {",
                 "      for (int off = 0 * g.splits; off > 0; off >>= 1) {"),
    "pass2": ("    for (int it = tid; it < nbe2 * S; it += T_) {",
              "    for (int it = tid; it < 0 * S; it += T_) {"),
    "stores": ("          if (e0 + e < DV) st(", "          if (acc[j][e] == 1234.5f) st("),
}


def _variant(src: str, part: str) -> str:
    old, new = PARTS[part]
    if src.count(old) != 1:
        raise RuntimeError(f"k2_phases: the text of part {part!r} is not in the source once")
    return src.replace(old, new)


def _build(sources: dict[str, str], out: Path) -> dict[str, ctypes.CDLL]:
    def one(item):
        name, text = item
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(text)
        proc = subprocess.run([build._nvcc(la.SOURCE), *build.NVCC_FLAGS, "-Xptxas", "-v",
                               "-o", str(so), str(cu)], check=True, capture_output=True,
                              text=True)
        ptxas = [line.strip() for line in proc.stderr.splitlines()
                 if "registers" in line or "spill" in line]
        lib = ctypes.CDLL(str(so))
        la._declare(lib)
        return name, (lib, ptxas)

    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per variant, together
        return dict(pool.map(one, sources.items()))


def _ms(fn, iters: int = 20, attempts: int = 3) -> float:
    """Device ms per call of the kernel, from a profiler trace (taken again, at most
    ``attempts`` times, when a trace saw no time of the kernel)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "linear_attention_kernel" in e.key)
        if us > 0:
            return us / 1e3 / iters
    raise RuntimeError(f"k2_phases: the profiler saw no time of the kernel in {attempts} traces")


def _device_ms(fn, iters: int = 10) -> float:
    """Device ms per call of every kernel ``fn`` launches (the plain version's several)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e3 / iters


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shapes", choices=["a1", "l"], default="a1")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_phases: no CUDA device; this script runs on the GPU")
    shapes = A1 if args.shapes == "a1" else L
    src = la.SOURCE.read_text()
    chosen, share = la.team_size, la.BLOCK_SMEM_BYTES
    with tempfile.TemporaryDirectory() as tmp:
        built = _build({"full": src, **{p: _variant(src, p) for p in PARTS}}, Path(tmp))
        print(json.dumps({"ptxas": {name: ptxas for name, (_, ptxas) in built.items()}}),
              flush=True)
        gen = torch.Generator().manual_seed(0)
        try:
            for stage, (nh, side, d, dv, variant, vc) in shapes.items():
                qk = (torch.randn(256, 2 * nh * d, side, side, generator=gen).abs()
                      + 0.1).to("cuda", torch.bfloat16)
                v = torch.randn(256, vc or nh * dv, side, side, generator=gen).to(
                    "cuda", torch.bfloat16)[:, : nh * dv]
                run = lambda: linear_attention_nchw(qk, v, nh)  # noqa: E731
                plain = _device_ms(
                    lambda: linear_attention_nchw_plain(qk, v, nh, variant=variant))
                phases = {}
                for name, (lib, _) in built.items():
                    la.LIBRARY._lib = lib
                    phases[name] = _ms(run)
                la.LIBRARY._lib = built["full"][0]
                teams = {}
                for team in la.TEAM_SIZES:
                    la.team_size = lambda *shape, team=team: team
                    la.launch_config.cache_clear()
                    la._launch_args.cache_clear()
                    teams[team] = _ms(run)
                la.team_size = chosen
                shares = {}
                for scale in (0.5, 2.0):
                    la.BLOCK_SMEM_BYTES = int(share * scale)
                    la.launch_config.cache_clear()
                    la._launch_args.cache_clear()
                    cfg = la.launch_config(side * side, d, dv, 2, "n")
                    shares[scale] = {"ms": _ms(run), "heads_per_block": cfg.heads_per_block,
                                     "tiles": cfg.tiles}
                la.BLOCK_SMEM_BYTES = share
                la.launch_config.cache_clear()
                la._launch_args.cache_clear()
                cfg = la.launch_config(side * side, d, dv, 2, "n")
                print(json.dumps({"shape_name": stage, "shape": [256 * nh, side * side, d, dv],
                                  "v_channel_slice_of": vc, "team": cfg.team,
                                  "heads_per_block": cfg.heads_per_block,
                                  "tiles": cfg.tiles, "phases_ms": phases, "teams_ms": teams,
                                  "block_share": shares, "plain_ms": plain}), flush=True)
        finally:
            la.team_size, la.BLOCK_SMEM_BYTES = chosen, share
            la.launch_config.cache_clear()
            la._launch_args.cache_clear()
            la.LIBRARY._lib = None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
