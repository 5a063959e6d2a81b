#!/usr/bin/env python3
"""Time design variants of the port's tensor-core conv3x3 + BN-statistics
kernel (K3) at ResNet-50's four 3x3 shapes.

    python3 tools/torch_k3_variants.py [--out PATH]

Needs one CUDA card and nvcc. Each variant is the committed
``mxnet_tpu_torch/csrc/conv3x3_bn_stats_tc.cu`` with a few lines replaced,
built with the port's nvcc flags (and ``csrc/`` on the include path, for
``hopper.cuh``) into ``mxnet_tpu_torch/_build/`` and run
through ``ops.kernels._launch_conv_tc`` on x (32, H, W, C) and w
(3, 3, C, C) in bf16 for (H = W, C) in (56, 64), (28, 128), (14, 256),
(7, 512). For each variant and tiling it prints y's largest error in
output ulps against the plain version (statistics within
chip_smoke.CONV_STATS_TOL_16 relative, except where they are left out) and
the device time (chip_smoke.device_ms) with its TFLOP/s and the bytes its
TMA loads bring to shared memory (and that rate), beside cuDNN's conv
alone, the card's name and its power limit. Tilings are (BM, BN); "rule" is
``ops.kernels._conv_tiles``'s choice. A variant that fails to build is
reported and skipped. Variants:

  committed    the source as it is, at the rule's tiles and at every
               (BM, BN) of 64 and 128
  stages2      2 ring stages for every tiling
  stages6      6 ring stages for every tiling
  no_stats     the statistics left out of the epilogue (time only)
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = ((56, 64), (28, 128), (14, 256), (7, 512))
N = 32
STAGES = "static constexpr int STAGES = C * BN >= 256 ? 3 : 4;"
STATS_START = "  // statistics: the thread's two rows"
STATS_END = "}\n\n// sums[0][c] = sum over M tiles"


def _replace(old, new):
    def edit(text):
        if old not in text:
            raise SystemExit(f"the source no longer has the lines a variant "
                             f"replaces:\n{old}")
        return text.replace(old, new)
    return edit


def _drop_stats(text):
    i, j = text.find(STATS_START), text.find(STATS_END)
    if i < 0 or j < i:
        raise SystemExit("the source no longer has the statistics block")
    return text[:i] + text[j:]


VARIANTS = {
    "committed": ([], ["rule", (128, 128), (128, 64), (64, 128),
                        (64, 64)]),
    "stages2": ([_replace(STAGES, "static constexpr int STAGES = 2;")],
                ["rule"]),
    "stages6": ([_replace(STAGES, "static constexpr int STAGES = 6;")],
                ["rule"]),
    "no_stats": ([_drop_stats], ["rule"]),
}


def l2_bytes(m_total, cin, cout, tiles):
    """Bytes the kernel's TMA loads bring to shared memory (from L2, mostly)
    for these tiles: every CTA loads a BM x 64 tile of x and a 64 x BN
    tile of w per (tap, 64 input channels) step."""
    bm, bn = tiles
    ctas = -(-m_total // bm) * (cout // bn)
    return ctas * 9 * (cin // 64) * (bm + bn) * 128


def build(name, text, build_dir, nvcc, flags):
    src = build_dir / f"k3_variant_{name}.cu"
    src.write_text(text)
    lib = build_dir / f"k3_variant_{name}.so"
    return lib, subprocess.Popen([nvcc, *flags, "-o", str(lib), str(src)],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def bind(path):
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_bn_stats_tc.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                        i, p]
    lib.conv3x3_bn_stats_tc.restype = i
    lib.conv3x3_tc_error_string.argtypes = [i]
    lib.conv3x3_tc_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to PATH as JSON")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_k3_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from mxnet_tpu_torch.ops import _build, kernels

    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_identity()
    base = (_build.CSRC / "conv3x3_bn_stats_tc.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (edits, _) in VARIANTS.items():
        text = base
        for edit in edits:
            text = edit(text)
        jobs[name] = build(name, text, _build.BUILD_DIR, _build._nvcc(),
                           [*_build.NVCC_FLAGS, "-I", str(_build.CSRC)])
    gen = torch.Generator(device="cuda").manual_seed(11)
    sms = kernels._sm_count(torch.cuda.current_device())
    cases = []
    for hw, c in SHAPES:
        x, w = chip_smoke.conv_inputs(torch, gen, N, hw, hw, c, c,
                                      torch.bfloat16)
        x_cf = x.permute(0, 3, 1, 2)
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        cudnn = chip_smoke.device_ms(lambda: F.conv2d(x_cf, w_cl, padding=1))
        cases.append(((N, hw, hw, c, c), x, w,
                      kernels.conv3x3_bn_stats_reference(x, w), cudnn))
    results = {"card": card, "variants": {},
               "cudnn_ms": {str(c[0]): c[4] for c in cases}}
    for name, (lib_path, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"{name:10s} failed to build:\n{out}", flush=True)
            results["variants"][name] = {"build_error": out[-2000:]}
            continue
        lib = bind(lib_path)
        kernels._conv_tc_library = lambda lib=lib: lib
        rows = results["variants"][name] = []
        for tiling in VARIANTS[name][1]:
            for shape, x, w, (yr, sr, qr), cudnn in cases:
                m, cout = shape[0] * shape[1] * shape[2], shape[4]
                tiles = (kernels._conv_tiles(m, cout, sms)
                         if tiling == "rule" else tiling)
                if cout % tiles[1]:
                    continue

                def run():
                    return kernels._launch_conv_tc(x, w, tiles)
                y, s, q = run()
                torch.cuda.synchronize()
                ulp = chip_smoke.ulp_err(torch, y, yr)
                stats = max(chip_smoke.rel_err(s, sr),
                            chip_smoke.rel_err(q, qr))
                ok = ulp <= 2 and (name == "no_stats"
                                   or stats <= chip_smoke.CONV_STATS_TOL_16)
                ms = chip_smoke.device_ms(run)
                flops = 2.0 * 9 * m * shape[3] * cout
                l2 = l2_bytes(m, shape[3], cout, tiles)
                rows.append({"shape": list(shape), "tiles": list(tiles),
                             "rule": tiling == "rule", "ms": ms,
                             "tflops": flops / ms / 1e9, "l2_bytes": l2,
                             "y_ulp": ulp, "stats_rel": stats, "ok": ok})
                print(f"{name:10s} {str(shape):22s} tiles {str(tiles):14s}"
                      f"{' (rule)' if tiling == 'rule' else '       '} "
                      f"{ms:.4f} ms device, {flops / ms / 1e9:.1f} TFLOP/s, "
                      f"tiles from L2 {l2 / 1e6:.1f} MB = "
                      f"{l2 / ms / 1e9:.2f} TB/s; {ms / cudnn:.2f}x cuDNN "
                      f"({cudnn:.4f} ms); y {ulp:.2f} ulp, stats rel "
                      f"{stats:.1e} {'ok' if ok else 'WRONG'}", flush=True)
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
