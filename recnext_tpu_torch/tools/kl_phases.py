"""Where K1's peeled-level kernel (``recconv_level_kernel``: the stride-2 down conv and
the stride-1 upsample-add-conv) and KL′3 (``recconv_up_adjoint_kernel``) of
``csrc/recconv_level_bwd.cu`` spend their time, on one GPU.

    python -m recnext_tpu_torch.tools.kl_phases
    python -m recnext_tpu_torch.tools.kl_phases --legacy DIR [--quick]

At every peeled plane the main paths run (``SHAPES``: the task paths' 128^2 and 200^2
at fp32, batch 16, C = 64; m1's 640^2 stage 0 at bf16, batch 2, C = 48; m1's 512^2 and
COCO's 200x334 for the adjoint; k = 5), the cases of a step (the down conv into fp32,
conv(x + up(y)) bilinear, the up-step's adjoint of dz), each first held against its
plain version; device ms per call from CUDA events around calls queued behind matmuls
(``tools/kl_bwd_phases.py:_queued_ms``):

* ``phases_ms``: the kernels as built, and builds with one phase compiled out each (the
  ``// phase NAME`` ... ``// end NAME`` regions of the source: copy, build, conv, store;
  ``tools/kl_bwd_phases.py:without``). What a phase costs is the full time less the
  time without it. The variants compute wrong results and are only timed.
* ``configs_ms``: the band (units a warp walks) and the ring depth that
  ``launch_config`` takes as ``band=`` and ``stages=``, against its own choice.
* ``library_ms``: ``F.conv2d(x.float(), ..., stride=2, groups=C)`` for the down conv and
  ``aten.upsample_bilinear2d_backward`` for the adjoint, on the same inputs.
* ``kernels``: the registers and local (spill) bytes of every instantiation at k = 5,
  and ``sass_f32_k5``: the static instruction mix of the fp32 kernels (``cuobjdump``).

``--legacy DIR`` also builds the forms before the bands and rings from DIR's
``recconv.cu`` (its ``recconv_level_forward``: one 32 x 32 tile a block) and
``recconv_level_bwd.cu`` (its ``recconv_up_adjoint``: a thread an element), e.g.
``git show <commit>:recnext_tpu_torch/csrc/recconv.cu > runs/old/recconv.cu``, times
them on the same inputs (``legacy_ms``) and says whether the outputs are bit-equal
to theirs (``same_bits_as_legacy``). ``--quick`` leaves out the phase cuts
and the sweeps. Builds go to a temporary directory; nothing of the package is changed.
Prints one JSON line per case and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from recnext_tpu_torch.ops.cuda import build
from recnext_tpu_torch.ops.cuda import recconv_level_bwd as lbwd
from recnext_tpu_torch.ops.cuda.recconv import _device_plan_table, pyramid_sizes
from recnext_tpu_torch.ops.cuda.recconv_bwd import MAX_FAN, _device_transposed_table
from recnext_tpu_torch.ops.recconv import (
    rec_conv2d_level,
    rec_conv2d_level_plain,
    rec_conv2d_up_adjoint,
    rec_conv2d_up_adjoint_plain,
)
from recnext_tpu_torch.tools.kl_bwd_phases import BANDS, _queued_ms, _sass, without

K = 5
PHASES = ("copy", "build", "conv", "store")
CASE_PHASES = {"level_s2": ("copy", "conv", "store"),
               "level_s1": ("copy", "build", "conv", "store"),
               "up_adjoint": ("copy", "conv", "store")}


def _declare_legacy(lib: ctypes.CDLL) -> None:
    """The C interfaces before the bands and rings: recconv.cu's level forward and
    recconv_level_bwd.cu's up adjoint (whichever the library has)."""
    if hasattr(lib, "recconv_level_forward"):
        lib.recconv_level_forward.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        lib.recconv_level_forward.restype = ctypes.c_int
    if hasattr(lib, "recconv_up_adjoint"):
        lib.recconv_up_adjoint.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.recconv_up_adjoint.restype = ctypes.c_int


def _nvcc(src: Path, so: Path, verbose: bool = False) -> str:
    flags = [*build.NVCC_FLAGS, "-Xptxas", "-v"] if verbose else build.NVCC_FLAGS
    out = subprocess.run([build._nvcc(src), *flags, "-o", str(so), str(src)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc {src}: {out.stdout}{out.stderr}")
    return out.stderr


def ptxas_lines(text: str) -> list[str]:
    """``-Xptxas -v``'s lines for the level kernel and the adjoint: each function's
    name, then its registers and spills."""
    keep, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and re.search(r"recconv_level_kernel|recconv_up_adjoint_kernel", name) and (
                "spill" in line or "registers" in line):
            keep.append(f"{name}: {line.strip()}")
    return keep


def _fwd_kernel(line: str) -> str | None:
    """The fp32 k = 5 level kernel or the adjoint a ``Function :`` line names, or None."""
    m = re.search(r"recconv_level_kernelIffLi5ELi([12])E", line)
    return (f"level_s{m.group(1)}" if m else
            "up_adjoint" if "recconv_up_adjoint_kernel" in line else None)


def _registers(lib) -> dict:
    out = {}
    for name, kind, stride, a, b in (("level_s2_f32", 3, 2, 0, 0), ("level_s2_bf16", 3, 2, 1, 0),
                                     ("level_s1_f32", 3, 1, 0, 0), ("level_s1_bf16", 3, 1, 1, 1),
                                     ("up_adjoint", 2, 1, 0, 0)):
        regs, local = ctypes.c_int(), ctypes.c_int()
        if lib.recconv_level_bwd_attributes(kind, K, stride, a, b, ctypes.byref(regs),
                                            ctypes.byref(local)) == 0:
            out[name] = {"registers": regs.value, "local_bytes": local.value}
    return out


# (name, n, c, h, w, x dtype, cases): the task paths' peeled planes (fp32, batch 16),
# m1's 640^2 stage-0 plane (its forward peels the level: bf16, batch 2), m1's 512^2
# train step's (the adjoint, batch 2) and COCO's 200x334 (batch 1)
SHAPES = (("task_128", 16, 64, 128, 128, torch.float32, ("level_s2", "level_s1", "up_adjoint")),
          ("task_200", 16, 64, 200, 200, torch.float32, ("level_s2", "level_s1", "up_adjoint")),
          ("m1_640", 2, 48, 160, 160, torch.bfloat16, ("level_s2", "level_s1")),
          ("m1_512", 2, 48, 128, 128, torch.float32, ("up_adjoint",)),
          ("coco", 1, 48, 200, 334, torch.float32, ("up_adjoint",)))


def _cases(n, c, h, wd, dtype, names, gen: torch.Generator):
    """(name, call, plain call, library call, legacy call on the library ``lib``) of the
    cases ``names`` at (n, c, h, wd), x in ``dtype`` (the down conv writes fp32, the
    stride-1 conv x's dtype)."""
    uh, uw = pyramid_sizes(h, wd, 1)[1]

    def t(*shape):
        return torch.randn(*shape, generator=gen).cuda()

    x, y, dz = t(n, c, h, wd).to(dtype), t(n, c, uh, uw), t(n, c, h, wd)
    w = (torch.randn(c, 1, K, K, generator=gen) / K).cuda()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    bf16 = int(dtype == torch.bfloat16)

    def legacy_level(lib, stride, up):
        out = torch.empty(n, c, *((h, wd) if stride == 1 else (uh, uw)), device="cuda",
                          dtype=dtype if stride == 1 else torch.float32)
        plans = _device_plan_table(h, wd, 1, "bilinear", x.device)
        err = lib.recconv_level_forward(x.data_ptr(), w.data_ptr(),
                                        None if up is None else up.data_ptr(),
                                        None if up is None else plans.data_ptr(),
                                        out.data_ptr(), n * c, c, h, wd, K, stride, bf16,
                                        bf16 if stride == 1 else 0, stream())
        if err:
            raise RuntimeError(f"legacy level forward: error {err}")
        return out

    def legacy_adjoint(lib):
        out = torch.empty(n, c, uh, uw, device="cuda")
        plans = _device_transposed_table(h, wd, 1, "bilinear", dz.device)
        err = lib.recconv_up_adjoint(dz.data_ptr(), plans.data_ptr(), out.data_ptr(), n * c,
                                     h, wd, uh * MAX_FAN, stream())
        if err:
            raise RuntimeError(f"legacy up adjoint: error {err}")
        return out

    cases = {
        "level_s2": (lambda: rec_conv2d_level(x, w, stride=2),
                     lambda: rec_conv2d_level_plain(x, w, stride=2),
                     lambda: F.conv2d(x.float(), w, stride=2, padding=K // 2, groups=c),
                     lambda lib: legacy_level(lib, 2, None)),
        "level_s1": (lambda: rec_conv2d_level(x, w, up=y),
                     lambda: rec_conv2d_level_plain(x, w, up=y), None,
                     lambda lib: legacy_level(lib, 1, y)),
        "up_adjoint": (lambda: rec_conv2d_up_adjoint(dz),
                       lambda: rec_conv2d_up_adjoint_plain(dz),
                       lambda: torch.ops.aten.upsample_bilinear2d_backward(
                           dz, [h, wd], [n, c, uh, uw], False),
                       legacy_adjoint)}
    return [(name, *cases[name]) for name in names]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, default=lbwd.SOURCE)
    ap.add_argument("--legacy", type=Path, default=None,
                    help="a directory with the older recconv.cu and recconv_level_bwd.cu")
    ap.add_argument("--quick", action="store_true", help="no phase cuts, no sweeps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kl_phases: no CUDA device; this script runs on the GPU")
    torch.backends.cudnn.allow_tf32 = False  # the plain version's convs in full fp32
    src = args.source.read_text()
    variants = {"full": src}
    if not args.quick:
        for phase in PHASES:
            cut = without(src, phase)
            if cut is not None:
                variants[phase] = cut
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)

        def one(item):
            name, text = item
            cu, so = out / f"{name}.cu", out / f"{name}.so"
            cu.write_text(text)
            log = _nvcc(cu, so, verbose=name == "full")
            lib = ctypes.CDLL(str(so))
            lbwd._declare(lib)
            return name, (lib, so, log)

        legacy = {}
        with ThreadPoolExecutor(len(variants) + 2) as pool:  # one nvcc each, together
            builds = pool.map(one, variants.items())
            if args.legacy:
                def old(name):
                    so = out / f"legacy_{name}.so"
                    _nvcc(args.legacy / f"{name}.cu", so)
                    lib = ctypes.CDLL(str(so))
                    _declare_legacy(lib)
                    return name, lib
                legacy = dict(pool.map(old, ("recconv", "recconv_level_bwd")))
            libs = dict(builds)
        full = libs["full"][0]
        print(json.dumps({"source": str(args.source), "ptxas": ptxas_lines(libs["full"][2]),
                          "kernels": _registers(full), "sass_f32_k5": _sass(libs["full"][1], _fwd_kernel)}),
              flush=True)
        planner = lbwd.launch_config
        lbwd.LIBRARY._lib = full  # the planner reads the full build's registers
        try:
            for plane, n, c, h, wd, dtype, names in SHAPES:
                gen = torch.Generator().manual_seed(h + wd)
                for name, run, plain, library, old in _cases(n, c, h, wd, dtype, names, gen):
                    got = run()
                    want = plain()
                    torch.cuda.synchronize()
                    rec = {"case": name, "plane": plane, "shape": [n, c, h, wd],
                           "x_dtype": str(dtype).removeprefix("torch."),
                           "max_abs_err": (got.float() - want.float()).abs().max().item(),
                           "max_abs_ref": want.float().abs().max().item(),
                           "same_bits_on_3_runs": all(torch.equal(run(), got) for _ in range(2))}
                    phases = {}
                    for variant, (lib, _, _) in libs.items():
                        if variant == "full" or variant in CASE_PHASES[name]:
                            lbwd.LIBRARY._lib = lib
                            phases[variant] = _queued_ms(run)
                    lbwd.LIBRARY._lib = full
                    rec["phases_ms"] = phases
                    rec["plain_ms"] = _queued_ms(plain, iters=5)
                    rec["library_ms"] = None if library is None else _queued_ms(library)
                    if legacy:
                        lib = legacy["recconv" if name.startswith("level") else
                                      "recconv_level_bwd"]
                        rec["legacy_ms"] = _queued_ms(lambda: old(lib))
                        rec["same_bits_as_legacy"] = torch.equal(old(lib), got)
                        rec["legacy_max_abs_diff"] = (old(lib).float() - got.float()).abs().max().item()
                    if not args.quick:
                        configs = {}
                        for band in (None, *BANDS):
                            for stages in lbwd.STAGES:
                                lbwd.launch_config = (
                                    lambda *a, _b=band, _s=stages, **kw: planner(
                                        *a, **kw, band=_b, stages=_s))
                                try:
                                    configs[f"band {band or 'auto'}, stages {stages}"] = \
                                        _queued_ms(run)
                                except ValueError:
                                    pass
                                finally:
                                    lbwd.launch_config = planner
                        rec["configs_ms"] = configs
                    print(json.dumps(rec), flush=True)
                torch.cuda.empty_cache()
        finally:
            lbwd.launch_config = planner
            lbwd.LIBRARY._lib = None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
