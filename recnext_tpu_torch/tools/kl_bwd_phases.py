"""Where the peeled level's backward kernels KL′1 (input gradient) and KL′2 (weight
gradient) of ``csrc/recconv_level_bwd.cu`` spend their time, on one GPU.

    python -m recnext_tpu_torch.tools.kl_bwd_phases
    python -m recnext_tpu_torch.tools.kl_bwd_phases --source OLD.cu --legacy

At the task paths' peeled planes (fp32, batch 16, C = 64, k = 5: 128^2 and 200^2), the
four cases of a train step (the input gradient at stride 1 and at stride 2 with dz
added; the weight gradient at stride 1 with z = x + up(y) and at stride 2), device ms
per call from CUDA events around calls queued behind matmuls (every kernel of the call:
the weight gradient's sum over its partial rows too):

* ``phases_ms``: the kernels as built, and builds with one phase compiled out each; the
  source marks a phase between a ``// phase NAME`` line and an ``// end NAME`` line (a
  name may mark several places). What a phase costs is the full time less the time
  without it. The stores and the weight-gradient sums are replaced by a cheap use of
  their values, so that the compiler keeps the work that feeds them. The variants
  compute wrong results and are only timed.
* ``configs_ms`` (the package's interface only): the band (units a warp walks) and the
  ring depth that ``launch_config`` takes as ``band=`` and ``stages=``, against its
  own choice.
* ``sass``: the static instruction mix of the fp32 k = 5 kernels as built
  (``cuobjdump -sass``), and each kernel's registers and local bytes.

``--legacy`` times a source with the C interface the kernels had before their bands
and rings (one 32 x 32 tile a block; e.g. ``git show <commit>:recnext_tpu_torch/csrc/
recconv_level_bwd.cu``): its phases are marked by the anchors of ``LEGACY_MARKS``.
Builds go to a temporary directory; nothing of the package is changed. Prints one JSON
line per case and the card's name and power limit.
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

from recnext_tpu_torch.ops.cuda import build
from recnext_tpu_torch.ops.cuda import recconv_level_bwd as lbwd
from recnext_tpu_torch.ops.cuda.recconv import _device_plan_table
from recnext_tpu_torch.ops.recconv import rec_conv2d_level_dgrad, rec_conv2d_level_wgrad

BATCH, CHANNELS, K = 16, 64, 5
SIDES = (128, 200)
PHASES = ("copy", "conv", "store", "build", "corr", "sums", "tile_sum")
KERNEL_PHASES = {"dgrad": ("copy", "conv", "store"),
                 "wgrad": ("copy", "build", "corr", "sums", "tile_sum")}
# what stands in for a phase where leaving it out would let the compiler drop more
REPLACE = {
    "store": "  if (q < W && v[0] + v[1] + v[2] + v[3] == 1234.5f) put(y, o, v[0]);\n",
    "sums": ("  float s = 0.f;\n#pragma unroll\n  for (int t = 0; t < KK; ++t) s += acc[t];\n"
             "  if (s == 1234.5f) partial[threadIdx.x] = s;\n")}
# the phases of the interface before the bands and rings: (phase, a substring of the
# region's first line and that line's offset, of its last line and that line's offset)
LEGACY_MARKS = (
    ("copy", "const int a = i / R, b = i - a * R, orow", -1, ": 0.f;", 1),
    ("conv", "if (S == 2 && ((row + P - i) & 1)) continue;", -2,
     "acc = fmaf(win[a * RP + b], wk[i * K + j], acc);", 2),
    ("copy", "const int r = i / R, q = i - r * R, gr = gr0 + r", -1, "win[r * RP + q] = v;", 1),
    ("corr", "  if (q0 + q < OW) {", 0,
     "acc[i * K + j] = fmaf(win[(S * r + i) * RP + S * q + j], gv, acc[i * K + j]);", 2),
    ("sums", "const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;", 0,
     "partial[(((size_t)c * N + n) * tiles + t) * KK + threadIdx.x] = s;", 1),
    ("tile_sum", "recconv_level_wgrad_sum_kernel<<<C * KK, kThreads, 0, s>>>(", 0,
     "static_cast<const float*>(partial), static_cast<float*>(dw), rows, KK);", 0))
SASS_OPS = ("LDS", "STS", "LDGSTS", "FFMA", "SHFL", "BAR", "LDG", "STG")
BANDS = (8, 16, 25, 32, 50, 64)  # output rows a warp walks, for configs_ms


def mark_legacy(src: str) -> str:
    """``src`` with the ``// phase`` / ``// end`` lines of LEGACY_MARKS inserted."""
    lines = src.split("\n")
    inserts = []
    for name, first, first_off, last, last_off in LEGACY_MARKS:
        i = next(n for n, line in enumerate(lines) if first in line
                 and not any(a <= n <= b for a, b, _ in inserts)) + first_off
        j = next(n for n in range(i, len(lines)) if last in lines[n]) + last_off
        inserts.append((i, j, name))
    for i, j, name in sorted(inserts, reverse=True):
        lines[j + 1:j + 1] = [f"// end {name}"]
        lines[i:i] = [f"// phase {name}"]
    return "\n".join(lines)


def without(src: str, phase: str) -> str | None:
    """``src`` with every region marked as ``phase`` replaced; None where none is."""
    pattern = re.compile(rf"^[ \t]*// phase {phase}\b.*?^[ \t]*// end {phase}\n", re.S | re.M)
    out, n = pattern.subn(REPLACE.get(phase, "").replace("\\", "\\\\"), src)
    return out if n else None


def _declare_legacy(lib: ctypes.CDLL) -> None:
    lib.recconv_level_dgrad.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    lib.recconv_level_wgrad.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    lib.recconv_level_bwd_attributes.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    for fn in (lib.recconv_level_dgrad, lib.recconv_level_wgrad,
               lib.recconv_level_bwd_attributes):
        fn.restype = ctypes.c_int


def _build(sources: dict, out: Path, legacy: bool) -> dict:
    def one(item):
        name, text = item
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(text)
        subprocess.run([build._nvcc(lbwd.SOURCE), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        (_declare_legacy if legacy else lbwd._declare)(lib)
        return name, (lib, so)

    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per variant, together
        return dict(pool.map(one, sources.items()))


def _bwd_kernel(line: str) -> str | None:
    """The fp32 k = 5 KL′1 / KL′2 kernel a ``Function :`` line names, or None."""
    m = re.search(r"recconv_level_(dgrad|wgrad)_kernelIffLi5ELi([12])E", line)
    return f"{m.group(1)}_s{m.group(2)}" if m else None


def _sass(so: Path, kernel_of=_bwd_kernel) -> dict:
    """Static opcode counts of the kernels in ``so`` that ``kernel_of`` names (from a
    ``cuobjdump -sass`` ``Function :`` line; by default the fp32 k = 5 KL′1 / KL′2)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True).stdout
    found, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = kernel_of(line)
            if name:
                found[name] = Counter()
        elif name:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                found[name][m.group(1).split(".")[0]] += 1
    return {k: {"instructions": sum(c.values()), **{op: c[op] for op in SASS_OPS}}
            for k, c in found.items()}


_AHEAD: list = []  # the matmul the timed calls queue behind


def _queued_ms(fn, iters: int = 20, ahead: int = 6) -> float:
    """Device ms per call: CUDA events around ``iters`` calls queued behind ``ahead``
    bf16 8192^2 matmuls, so that the host's time per call is hidden; the best of 3."""
    if not _AHEAD:
        _AHEAD.append(torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16))
    a = _AHEAD[0]
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        for _ in range(ahead):
            a @ a
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def _cases(side: int, gen: torch.Generator, legacy: dict | None = None):
    """(name, kernel, call) of the four cases at side^2: the package's entries, or the
    legacy interface's C functions on the library ``legacy["lib"]`` at call time."""
    n, c, h = BATCH, CHANNELS, side
    dh = (h + 1) // 2

    def t(*shape):
        return torch.randn(*shape, generator=gen).cuda()

    x, g, y, dd, dz = t(n, c, h, h), t(n, c, h, h), t(n, c, dh, dh), t(n, c, dh, dh), t(n, c, h, h)
    w = (torch.randn(c, 1, K, K, generator=gen) / K).cuda()
    if legacy is None:
        return [("dgrad_s1", "dgrad", lambda: rec_conv2d_level_dgrad(g, w, size=(h, h))),
                ("dgrad_s2", "dgrad", lambda: rec_conv2d_level_dgrad(dd, w, size=(h, h),
                                                                     stride=2, add=dz)),
                ("wgrad_s1", "wgrad", lambda: rec_conv2d_level_wgrad(x, g, k=K, up=y)),
                ("wgrad_s2", "wgrad", lambda: rec_conv2d_level_wgrad(x, dd, k=K, stride=2))]
    plans = _device_plan_table(h, h, 1, "bilinear", x.device)
    out = torch.empty(n, c, h, h, device="cuda")
    dw = torch.empty(c, 1, K, K, device="cuda")
    partial = torch.empty(c, n * (-(-h // 32)) ** 2, K * K, device="cuda")

    def dgrad(src, stride, add):
        legacy["lib"].recconv_level_dgrad(
            src.data_ptr(), w.data_ptr(), None if add is None else add.data_ptr(),
            out.data_ptr(), n * c, c, h, h, K, stride, 0, 0,
            torch.cuda.current_stream().cuda_stream)

    def wgrad(gg, stride, up):
        legacy["lib"].recconv_level_wgrad(
            x.data_ptr(), None if up is None else up.data_ptr(),
            None if up is None else plans.data_ptr(), gg.data_ptr(), partial.data_ptr(),
            dw.data_ptr(), n, c, h, h, K, stride, 0, 0, torch.cuda.current_stream().cuda_stream)

    return [("dgrad_s1", "dgrad", lambda: dgrad(g, 1, None)),
            ("dgrad_s2", "dgrad", lambda: dgrad(dd, 2, dz)),
            ("wgrad_s1", "wgrad", lambda: wgrad(g, 1, y)),
            ("wgrad_s2", "wgrad", lambda: wgrad(dd, 2, None))]


def _registers(lib) -> dict:
    out = {}
    for kind, code in (("dgrad", 0), ("wgrad", 1)):
        for stride in (1, 2):
            regs, local = ctypes.c_int(), ctypes.c_int()
            if lib.recconv_level_bwd_attributes(code, K, stride, 0, 0, ctypes.byref(regs),
                                                ctypes.byref(local)) == 0:
                out[f"{kind}_s{stride}"] = {"registers": regs.value,
                                            "local_bytes": local.value}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, default=lbwd.SOURCE)
    ap.add_argument("--legacy", action="store_true",
                    help="the source has the interface before the bands and rings")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kl_bwd_phases: no CUDA device; this script runs on the GPU")
    src = args.source.read_text()
    if args.legacy:
        src = mark_legacy(src)
    variants = {"full": src}
    for phase in PHASES:
        cut = without(src, phase)
        if cut is not None:
            variants[phase] = cut
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build(variants, Path(tmp), args.legacy)
        emit = {"source": str(args.source), "legacy": args.legacy,
                "sass_f32_k5": _sass(libs["full"][1]), "kernels": _registers(libs["full"][0])}
        print(json.dumps(emit), flush=True)
        planner = lbwd.launch_config
        holder = {"lib": libs["full"][0]}
        lbwd.LIBRARY._lib = holder["lib"]  # the planner reads the full build's registers
        try:
            for side in SIDES:
                cases = _cases(side, torch.Generator().manual_seed(side),
                               holder if args.legacy else None)
                for name, kind, run in cases:
                    phases = {}
                    for variant, (lib, _) in libs.items():
                        if variant == "full" or variant in KERNEL_PHASES[kind]:
                            holder["lib"] = lbwd.LIBRARY._lib = lib
                            phases[variant] = _queued_ms(run)
                    holder["lib"] = lbwd.LIBRARY._lib = libs["full"][0]
                    rec = {"case": name, "shape": [BATCH, CHANNELS, side, side],
                           "phases_ms": phases}
                    if not args.legacy:
                        configs = {}
                        unit = 2 if name == "dgrad_s2" else 1  # output rows a unit
                        for band in (None, *BANDS):
                            for stages in lbwd.STAGES:
                                lbwd.launch_config = (
                                    lambda *a, _b=band, _s=stages, **kw: planner(
                                        *a, **kw, band=None if _b is None else -(-_b // unit),
                                        stages=_s))
                                try:
                                    configs[f"band {band or 'auto'}, stages {stages}"] = \
                                        _queued_ms(run)
                                except ValueError:
                                    pass
                                finally:
                                    lbwd.launch_config = planner
                        rec["configs_ms"] = configs
                    del run
                    print(json.dumps(rec), flush=True)
                del cases
                torch.cuda.empty_cache()
        finally:
            lbwd.launch_config = planner
            lbwd.LIBRARY._lib = None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
