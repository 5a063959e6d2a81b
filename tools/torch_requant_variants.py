#!/usr/bin/env python3
"""Why K5's requantize takes longer on some values than on others, and
what its redesign buys: ``csrc/requant_int8.cu``'s SASS around its IEEE
divisions, and its device time over a sweep of input values, for design
variants, at ResNet-18 v1's largest requantize shape (128 x 64 x 56 x 56).

    python3 tools/torch_requant_variants.py [--variants a,b,...] [--out PATH]

Needs one CUDA card and nvcc (cuobjdump from the same toolkit for the
SASS). Each variant is the committed ``mxnet_tpu_torch/csrc/requant_int8.cu``
and ``csrc/requant.cuh`` with a few lines replaced, built with the port's
nvcc flags into its own directory under ``mxnet_tpu_torch/_build/`` and
loaded in the committed library's place, so ``ops.quantization``'s
``requant_epilogue`` launches it. For each variant it prints ptxas's
registers, the SASS's count of FCHK (the division's range check) and
CALL (to its slow path) in each kernel, and for each input kind of
chip_smoke's RQ_SWEEP the device time (chip_smoke.device_ms) of the
calibrated mode and of mode "own" (the batch range computed first), each
output held bitwise to the plain version, beside the bound (5 bytes an
element; mode own's kernel reads x twice: 9). The committed variant's SASS
around its first division is printed once. Variants:

  committed   the source as it is: 4 16-byte loads a thread before any
              store, a 0 skips the division
  no_skip     every input divided (the zero shortcut left out)
  unroll1     one 16-byte load a thread
  first       both: the first version's arithmetic and loads in flight
              (one CTA a tile of 1024 elements, where it looped over 2
              CTAs an SM)
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (128, 64, 56, 56)
SKIP = "  const bool zero = x == 0 && sc.skip0;"
UNROLL = "constexpr int UNROLL = 4;"


def _edit(name, old, new):
    def edit(files):
        if old not in files[name]:
            raise SystemExit(f"{name} no longer has the line a variant "
                             f"replaces:\n{old}")
        files[name] = files[name].replace(old, new)
    return edit


VARIANTS = {
    "committed": [],
    "no_skip": [_edit("requant.cuh", SKIP, "  const bool zero = false;")],
    "unroll1": [_edit("requant_int8.cu", UNROLL,
                      "constexpr int UNROLL = 1;")],
    "first": [_edit("requant.cuh", SKIP, "  const bool zero = false;"),
              _edit("requant_int8.cu", UNROLL, "constexpr int UNROLL = 1;")],
}


def _cuobjdump(nvcc):
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    return cand if os.path.exists(cand) else None


def sass_counts(sass):
    """{kernel: {"FCHK": n, "CALL": n}} from cuobjdump -sass output."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            cur = ("requant_range_kernel" if "range_kernel" in name else
                   "requant_kernel<1>" if "ILi1E" in name else
                   "requant_kernel<0>")
            out[cur] = {"FCHK": 0, "CALL": 0}
        elif cur is not None:
            for op in ("FCHK", "CALL"):
                if re.search(rf"\b{op}\b", line):
                    out[cur][op] += 1
    return out


def sass_window(sass, lines=28):
    """The SASS of requant_kernel<0> around its second FCHK (the first
    checks real_in / 2147483647; the second, the element's division)."""
    body = sass.split("requant_kernelILi0E", 1)[-1].splitlines()
    hits = [i for i, ln in enumerate(body) if "FCHK" in ln]
    if len(hits) < 2:
        return ""
    at = hits[1]
    return "\n".join(ln.split(";")[0].strip() for ln in
                     body[max(0, at - 16):at + lines - 16]
                     if ln.strip().startswith("/*"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants to time")
    ap.add_argument("--out", help="also write the results to PATH as JSON")
    args = ap.parse_args(argv)
    names = args.variants.split(",")

    import torch

    if not torch.cuda.is_available():
        print("torch_requant_variants: CUDA is not available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import quantization as q

    card = chip_smoke.card_identity()
    nvcc = _build._nvcc()
    objdump = _cuobjdump(nvcc)
    base = {f: (_build.CSRC / f).read_text()
            for f in ("requant_int8.cu", "requant.cuh")}
    jobs = {}
    for name in names:
        files = dict(base)
        for edit in VARIANTS[name]:
            edit(files)
        d = _build.BUILD_DIR / f"rq_variant_{name}"
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        lib = d / "librequant_int8.so"
        jobs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib),
             str(d / "requant_int8.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    gen = torch.Generator(device="cuda").manual_seed(16)
    f32 = dict(dtype=torch.float32, device="cuda")
    real_in = torch.tensor(1.7e4, **f32)
    lo, hi = torch.tensor(-9.0, **f32), torch.tensor(11.5, **f32)
    inputs = {k: chip_smoke.rq_sweep_input(torch, gen, SHAPE, k)
              for k in chip_smoke.RQ_SWEEP}
    want = {}
    for kind, x in inputs.items():
        rng = q.requant_range_reference(x, real_in)
        want[kind] = (q.requant_epilogue_reference(x, real_in, lo, hi),
                      q.requant_epilogue_reference(x, real_in, -rng, rng))
    n = x.numel()
    bound = chip_smoke.int8_bound(0, 5.0 * n)[0]
    bound_own = chip_smoke.int8_bound(0, 9.0 * n)[0]
    print(f"requantize at {SHAPE} ({n} elements): bound {bound:.4f} ms "
          f"(5 bytes an element); mode own's kernel reads x twice: "
          f"{bound_own:.4f} ms", flush=True)
    results = {"card": card, "shape": list(SHAPE), "bound_ms": bound,
               "own_kernel_bound_ms": bound_own, "variants": {}}
    for name in names:
        lib_path, proc = jobs[name]
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"{name:10s} failed to build:\n{out}", flush=True)
            results["variants"][name] = {"build_error": out[-2000:]}
            continue
        usage = [f"{e}: {u}" for e, u in chip_smoke.ptxas_usage(out)]
        sass = subprocess.run([objdump, "-sass", str(lib_path)],
                              capture_output=True, text=True).stdout \
            if objdump else ""
        counts = sass_counts(sass)
        print(f"{name:10s} ptxas: {'; '.join(usage)}", flush=True)
        print(f"{name:10s} SASS FCHK / CALL by kernel: {counts}", flush=True)
        if name == "committed" and sass:
            print("committed  SASS of requant_kernel<0> around an element's "
                  "division:\n" + sass_window(sass), flush=True)
        _build._libs["requant_int8"] = ctypes.CDLL(str(lib_path))
        rows = results["variants"][name] = {"sass": counts, "ptxas": usage,
                                            "ms": {}, "own_ms": {}}
        for kind, x in inputs.items():
            got = q.requant_epilogue(x, real_in, lo, hi)
            own = q.requant_epilogue(x, real_in)
            torch.cuda.synchronize()
            exact = all(torch.equal(g, w) for g, w in
                        zip(got + own, want[kind][0] + want[kind][1]))
            ms = chip_smoke.device_ms(
                lambda: q.requant_epilogue(x, real_in, lo, hi))
            own_ms = chip_smoke.device_ms(
                lambda: q.requant_epilogue(x, real_in))
            rows["ms"][kind], rows["own_ms"][kind] = ms, own_ms
            print(f"{name:10s} {kind:22s} calibrated {ms:.4f} ms "
                  f"({bound / ms:.1%} of bound), own range {own_ms:.4f} ms "
                  f"({bound / own_ms:.1%}; {bound_own / own_ms:.1%} of the "
                  f"bytes it moves); bitwise {exact} "
                  f"{'ok' if exact else 'WRONG'}", flush=True)
    _build._libs.pop("requant_int8", None)
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
