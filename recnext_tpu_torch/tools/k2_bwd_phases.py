"""Where the linear-attention backward kernel K2' (``csrc/linear_attention_bwd.cu``)
spends its time, on one GPU.

    python -m recnext_tpu_torch.tools.k2_bwd_phases [--against OTHER.cu]

At recnext_a1's four training shapes (batch 128, bf16, the model's NCHW entry
``linear_attention_nchw_backward``; D = DV = 24), device ms per call from CUDA
events around calls queued behind other work (``queued_ms``), so that the host's
time per call is hidden:

* ``phases_ms``: the kernel as built, and builds of it with one phase compiled out
  each; the source marks a phase's code between a ``// phase NAME`` line and an
  ``// end NAME`` line (a name may mark several places; the names are read from the
  source). What a phase costs is the full time less the time without it. The
  stores are replaced by a store that never runs, so that the compiler keeps what
  feeds them. The variants compute wrong results and are only timed.
* ``configs_ms``: the kernel as built with every launch configuration that fits
  (``ops/cuda/linear_attention_bwd.py:candidates``: each packed team size, each
  cluster size, the tiled walk), in place of ``launch_config``'s choice, each with
  its resident blocks per SM.
* ``sass``: the instruction mix of the bf16 kernels as built (``cuobjdump -sass``).
* ``profiler``: launches per call that ``torch.profiler``'s ``key_averages`` and its
  exported trace list for K2' and, as a control, for K2, over 10 calls; and, at the
  end, for K2' again after 30 more profiler sessions in the same process (as
  ``chip_smoke.py`` runs many before it times K2').

With ``--against``, a build of another version of the source (same C interface) is
timed beside the kernel as built, in turns (this, other, other, this), at every
shape: ``against_ms``.

Prints registers and local bytes of each build's kernels, one JSON line per shape and the
card's name and power limit. Builds go to a temporary directory; nothing of the
package is changed.
"""

from __future__ import annotations

import argparse
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

from recnext_tpu_torch.ops.attention import linear_attention_nchw, linear_attention_nchw_backward
from recnext_tpu_torch.ops.cuda import build
from recnext_tpu_torch.ops.cuda import linear_attention_bwd as bwd

A1 = {0: (2, 28), 1: (4, 14), 2: (8, 7), 3: (16, 4)}  # stage: (heads, side); D = DV = 24
HEAD_DIM = 24
BATCH = 128
# what stands in for a phase where leaving it out would let the compiler drop more
REPLACE = {"store": "  if (v == 1234.5f) st(p, v);\n"}
SASS_OPS = ("LDS", "STS", "LDG", "STG", "LDGSTS", "FFMA", "FMUL", "FADD", "SHFL", "BAR",
            "F2F", "PRMT", "IMAD")


def phases_of(src: str) -> list[str]:
    """The phase names marked in ``src``, in order of first appearance."""
    return list(dict.fromkeys(re.findall(r"^[ \t]*// phase (\w+)", src, re.M)))


def without(src: str, phase: str) -> str:
    """``src`` with every region marked as ``phase`` replaced."""
    pattern = re.compile(rf"^[ \t]*// phase {phase}\b.*?^[ \t]*// end {phase}\n",
                         re.S | re.M)
    out, n = pattern.subn(REPLACE.get(phase, "").replace("\\", "\\\\"), src)
    if n == 0:
        raise ValueError(f"k2_bwd_phases: no region marked '{phase}' in {bwd.SOURCE}")
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
    """Opcode counts of each bf16 kernel in the library ``so``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True).stdout
    kernels, counts = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts = Counter() if "bfloat16" in name else None
            if counts is not None:
                kernels[name[:80]] = counts
        elif counts is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1)] += 1
    return {name: {"instructions": sum(c.values()), **{op: c[op] for op in SASS_OPS}}
            for name, c in kernels.items()} or None


def queued_ms(fn, iters: int = 20, ahead: int = 6) -> float:
    """Device ms per call from CUDA events around ``iters`` calls queued behind
    ``ahead`` bf16 8192^2 matmuls (about 1 ms each), so that the host's time per call
    is hidden (as ``chip_smoke.py:queued_ms``)."""
    a = torch.ones(8192, 8192, device="cuda", dtype=torch.bfloat16)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(ahead):
        a @ a
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiler_launches(fn, name: str, iters: int = 10, sync_each: bool = False) -> dict:
    """Launches per call of kernels whose name holds ``name``, as ``key_averages``
    and as the exported trace list them, over ``iters`` calls after 3 warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
            if sync_each:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    averaged = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key)
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.loads(Path(f.name).read_text()).get("traceEvents", [])
    in_trace = [e for e in events if e.get("cat") == "kernel" and name in e.get("name", "")]
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", "")]
    return {"key_averages": averaged / iters, "trace_kernels": len(in_trace) / iters,
            "trace_runtime_launches": len(launches) / iters}


def _inputs(nh: int, side: int, gen: torch.Generator):
    qk = torch.randn(BATCH, 2 * nh * HEAD_DIM, side, side, generator=gen).abs() + 0.1
    v = torch.randn(BATCH, nh * HEAD_DIM, side, side, generator=gen)
    g = torch.randn(BATCH, nh * HEAD_DIM, side, side, generator=gen)
    return (t.to("cuda", torch.bfloat16) for t in (qk, v, g))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="another version of csrc/linear_attention_bwd.cu to time beside it")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_bwd_phases: no CUDA device; this script runs on the GPU")
    src = bwd.SOURCE.read_text()
    names = phases_of(src)
    with tempfile.TemporaryDirectory() as tmp:
        sources = {"full": src, **{p: without(src, p) for p in names}}
        if args.against:
            sources["against"] = args.against.read_text()
        libs = _build(sources, Path(tmp))
        builds = {}
        for name, (lib, _) in libs.items():
            bwd.LIBRARY._lib = lib
            builds[name] = {route: bwd.kernel_attributes(torch.bfloat16, route)
                            for route in ("packed", "tiled")}
        bwd.LIBRARY._lib = libs["full"][0]
        print(json.dumps({"builds_bf16": builds, "sass_bf16": _sass(libs["full"][1])}),
              flush=True)
        gen = torch.Generator().manual_seed(0)
        chosen = bwd.launch_config
        try:
            for stage, (nh, side) in A1.items():
                n = side * side
                qk, v, g = _inputs(nh, side, gen)
                run = lambda: linear_attention_nchw_backward(qk, v, g, nh)  # noqa: E731
                phases, against = {}, {}
                for name, (lib, _) in libs.items():
                    bwd.LIBRARY._lib = lib
                    if name != "against":
                        phases[name] = queued_ms(run)
                if args.against:
                    for name in ("full", "against", "against", "full"):
                        bwd.LIBRARY._lib = libs[name][0]
                        against.setdefault(name, []).append(queued_ms(run))
                bwd.LIBRARY._lib = libs["full"][0]
                configs = {}
                for label, cfg in bwd.candidates(n, HEAD_DIM, HEAD_DIM, 2, "n").items():
                    bwd.launch_config = lambda *a, cfg=cfg: cfg
                    bwd._launch_args.cache_clear()
                    configs[label] = {"ms": queued_ms(run),
                                      "resident_blocks": bwd.resident_blocks(cfg, torch.bfloat16)}
                bwd.launch_config = chosen
                bwd._launch_args.cache_clear()
                cfg = chosen(n, HEAD_DIM, HEAD_DIM, 2, "n")
                fwd = lambda: linear_attention_nchw(qk, v, nh)  # noqa: E731
                prof = {"k2_bwd": profiler_launches(run, "linear_attention_bwd"),
                        "k2_bwd_sync_each": profiler_launches(run, "linear_attention_bwd",
                                                              sync_each=True),
                        "k2_forward": profiler_launches(fwd, "linear_attention_kernel")}
                print(json.dumps({
                    "stage": stage, "bh": BATCH * nh, "n": n, "d": HEAD_DIM, "dv": HEAD_DIM,
                    "launch": {k: v for k, v in cfg._asdict().items() if k != "geometry"},
                    "resident_blocks": bwd.resident_blocks(cfg, torch.bfloat16),
                    "phases_ms": phases, "configs_ms": configs, "profiler": prof,
                    **({"against_ms": against} if against else {})}),
                    flush=True)
            nh, side = A1[2]
            qk, v, g = _inputs(nh, side, gen)
            run = lambda: linear_attention_nchw_backward(qk, v, g, nh)  # noqa: E731
            for _ in range(30):
                profiler_launches(run, "linear_attention_bwd")
            print(json.dumps({"profiler_after_30_sessions": {
                "k2_bwd": profiler_launches(run, "linear_attention_bwd"),
                "k2_forward": profiler_launches(lambda: linear_attention_nchw(qk, v, nh),
                                                "linear_attention_kernel")}}), flush=True)
        finally:
            bwd.launch_config = chosen
            bwd._launch_args.cache_clear()
            bwd.LIBRARY._lib = None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
