#!/usr/bin/env python3
"""Time design variants of the port's tensor-core conv3x3 + BN-statistics
kernels (K3: the 16-bit route "tc" and the fp32 3xTF32 route "tf32x3") at
ResNet-50's four 3x3 shapes.

    python3 tools/torch_k3_variants.py [--route tc|tf32x3|both] [--out PATH]

Needs one CUDA card and nvcc. Each variant is the committed
``mxnet_tpu_torch/csrc/conv3x3_bn_stats_tc.cu`` (bf16 inputs) or
``conv3x3_bn_stats_tf32x3.cu`` (fp32 inputs) with a few lines replaced,
built with the port's nvcc flags (and ``csrc/`` on the include path, for
its headers) into ``mxnet_tpu_torch/_build/`` and run through
``ops.kernels._launch_conv_tc`` / ``_launch_conv_tf32x3`` on x (32, H, W, C)
and w (3, 3, C, C) for (H = W, C) in (56, 64), (28, 128), (14, 256),
(7, 512) (shapes whose C a variant's tiles do not divide are skipped). For
each variant and tiling it prints the largest error against
the plain version (tc: y in output ulps, statistics within
chip_smoke.CONV_STATS_TOL_16 relative; tf32x3: y, sum and sumsq of
max|ref| within chip_smoke.CONV_TF32X3_TOL), the device time
(chip_smoke.device_ms) with its TFLOP/s of the needed products and the
bytes its TMA loads bring to shared memory (and that rate), beside cuDNN's
conv alone in the same dtype (TF32 off), ptxas's registers and spills, the
card's name and its power limit. Tilings are (BM, BN); "rule" is
``ops.kernels._conv_tiles``'s choice (tc); the tf32x3 kernel's tiling is
fixed in its source (TILE_C, TILE_BN), so its tiling variants edit that
line. A variant that fails to build is reported and skipped. Variants:

  tc committed        the source as it is, at the rule's tiles and at every
                      (BM, BN) of 64 and 128
  tc stages2          2 ring stages for every tiling
  tc stages6          6 ring stages for every tiling
  tc no_stats         the statistics left out of the epilogue (time only)
  tf32x3 committed    the source as it is (64 x 64 tiles)
  tf32x3 tiles_128x64, tiles_128x128, tiles_64x128
                      the same source with other tiles
  tf32x3 one_accumulator  every product into one wgmma accumulator (no
                      stage accumulator added to an f32 sum on the CUDA
                      cores): the time and the error the tensor cores'
                      truncating accumulation costs
  tf32x3 one_pass     one TF32 pass (hi x hi) per product (time, and the
                      error it costs)
  tf32x3 stages3, stages4  3 or 4 ring stages (2 committed)
  tf32x3 no_stats     the statistics left out of the epilogue (time only)
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
TC_STAGES = "static constexpr int STAGES = C * BN >= 256 ? 3 : 4;"
TF32_STAGES = "static constexpr int STAGES = 2;"
TF32_TILE = "constexpr int TILE_C = 1, TILE_BN = 64;"
STATS_START = "  // statistics: the thread's two rows"
STATS_END = ("}\n\n// ------------------------------------------------"
             "------------------ host")
TF32_PRODUCTS = """      wgmma_rs_tf32<BN>(part_acc, lo[kk], dh, kk > 0);
      wgmma_rs_tf32<BN>(part_acc, hi[kk],
                        sw128_desc(bl + kk * 32, 16, 1024));
      wgmma_rs_tf32<BN>(part_acc, hi[kk], dh);"""
TF32_PIN = "    pin<BN / 2>(part_acc);"
TF32_PROMOTE = """#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part_acc[i];"""


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


TC_TILINGS = ["rule", (128, 128), (128, 64), (64, 128), (64, 64)]


def _tf32_tiles(bm, bn):
    return ([_replace(TF32_TILE, f"constexpr int TILE_C = {bm // 64}, "
                                 f"TILE_BN = {bn};")], [(bm, bn)])


# route -> {variant: (edits, tilings)}; a tf32x3 variant's one tiling is
# the one its source has
FIXED = [(64, 64)]
VARIANTS = {
    "tc": {
        "committed": ([], TC_TILINGS),
        "stages2": ([_replace(TC_STAGES,
                              "static constexpr int STAGES = 2;")], ["rule"]),
        "stages6": ([_replace(TC_STAGES,
                              "static constexpr int STAGES = 6;")], ["rule"]),
        "no_stats": ([_drop_stats], ["rule"]),
    },
    "tf32x3": {
        "committed": ([], FIXED),
        "tiles_128x64": _tf32_tiles(128, 64),
        "tiles_128x128": _tf32_tiles(128, 128),
        "tiles_64x128": _tf32_tiles(64, 128),
        "one_accumulator": ([
            _replace(TF32_PRODUCTS, TF32_PRODUCTS.replace(
                "part_acc", "acc").replace(", kk > 0", "")),
            _replace(TF32_PIN, "    pin<BN / 2>(acc);"),
            _replace(TF32_PROMOTE, "")], FIXED),
        "one_pass": ([_replace(
            TF32_PRODUCTS,
            "      wgmma_rs_tf32<BN>(part_acc, hi[kk], dh, kk > 0);")],
            FIXED),
        "stages3": ([_replace(TF32_STAGES,
                              "static constexpr int STAGES = 3;")], FIXED),
        "stages4": ([_replace(TF32_STAGES,
                              "static constexpr int STAGES = 4;")], FIXED),
        "no_stats": ([_drop_stats], FIXED),
    },
}
TIME_ONLY = ("no_stats",)
SOURCE = {"tc": "conv3x3_bn_stats_tc", "tf32x3": "conv3x3_bn_stats_tf32x3"}


def l2_bytes(route, m_total, cin, cout, tiles):
    """Bytes the kernel's TMA loads bring to shared memory (from L2, mostly)
    for these tiles: every CTA loads, per (tap, 128-byte channel chunk)
    step, a BM-pixel tile of x and a BN-channel tile of w (tf32x3: its hi
    and lo parts)."""
    bm, bn = tiles
    ctas = -(-m_total // bm) * (cout // bn)
    if route == "tc":
        return ctas * 9 * (cin // 64) * (bm + bn) * 128
    return ctas * 9 * (cin // 32) * (bm + 2 * bn) * 128


def build(name, text, build_dir, nvcc, flags):
    src = build_dir / f"k3_variant_{name}.cu"
    src.write_text(text)
    lib = build_dir / f"k3_variant_{name}.so"
    return lib, subprocess.Popen([nvcc, *flags, "-o", str(lib), str(src)],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def bind(route, path):
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    if route == "tc":
        lib.conv3x3_bn_stats_tc.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                            i, i, p]
        lib.conv3x3_bn_stats_tc.restype = i
        lib.conv3x3_tc_error_string.argtypes = [i]
        lib.conv3x3_tc_error_string.restype = ctypes.c_char_p
    else:
        lib.conv3x3_bn_stats_tf32x3.argtypes = [p] * 6 + [i] * 5 + [p]
        lib.conv3x3_bn_stats_tf32x3.restype = i
        lib.conv3x3_tf32x3_block_m.restype = i
        lib.conv3x3_tf32x3_pack_w.argtypes = [p, p, i, i, p]
        lib.conv3x3_tf32x3_pack_w.restype = i
        lib.conv3x3_tf32x3_error_string.argtypes = [i]
        lib.conv3x3_tf32x3_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", choices=("tc", "tf32x3", "both"),
                    default="both", help="which kernel's variants to time")
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
    routes = ("tc", "tf32x3") if args.route == "both" else (args.route,)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for route in routes:
        base = (_build.CSRC / f"{SOURCE[route]}.cu").read_text()
        for name, (edits, _) in VARIANTS[route].items():
            text = base
            for edit in edits:
                text = edit(text)
            jobs[route, name] = build(
                f"{route}_{name}", text, _build.BUILD_DIR, _build._nvcc(),
                [*_build.NVCC_FLAGS, "-I", str(_build.CSRC)])
    gen = torch.Generator(device="cuda").manual_seed(11)
    sms = kernels._sm_count(torch.cuda.current_device())
    results = {"card": card, "variants": {}, "cudnn_ms": {}}
    for route in routes:
        dtype = torch.bfloat16 if route == "tc" else torch.float32

        def launch(x, w, tiles, route=route):
            if route == "tc":
                return kernels._launch_conv_tc(x, w, tiles)
            return kernels._launch_conv_tf32x3(x, w)
        cases = []
        for hw, c in SHAPES:
            x, w = chip_smoke.conv_inputs(torch, gen, N, hw, hw, c, c, dtype)
            x_cf = x.permute(0, 3, 1, 2)
            w_cl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            cudnn = chip_smoke.device_ms(
                lambda: F.conv2d(x_cf, w_cl, padding=1))
            shape = (N, hw, hw, c, c)
            results["cudnn_ms"][f"{route} {shape}"] = cudnn
            cases.append((shape, x, w,
                          kernels.conv3x3_bn_stats_reference(x, w), cudnn))
        for name in VARIANTS[route]:
            lib_path, proc = jobs[route, name]
            out, _ = proc.communicate()
            tag = f"{route} {name}"
            if proc.returncode:
                print(f"{tag:24s} failed to build:\n{out}", flush=True)
                results["variants"][tag] = {"build_error": out[-2000:]}
                continue
            usage = [f"{e}: {u}" for e, u in chip_smoke.ptxas_usage(out)
                     if "conv3x3" in e]
            print(f"{tag:24s} ptxas: " + " | ".join(
                usage + chip_smoke.ptxas_advisories(out)), flush=True)
            lib = bind(route, lib_path)
            if route == "tc":
                kernels._conv_tc_library = lambda lib=lib: lib
            else:
                kernels._conv_tf32x3_library = lambda lib=lib: lib
            rows = results["variants"][tag] = []
            for tiling in VARIANTS[route][name][1]:
                for shape, x, w, (yr, sr, qr), cudnn in cases:
                    m, cout = shape[0] * shape[1] * shape[2], shape[4]
                    tiles = (kernels._conv_tiles(m, cout, sms)
                             if tiling == "rule" else tiling)
                    if cout % tiles[1]:
                        continue

                    def run():
                        return launch(x, w, tiles)
                    y, s, q = run()
                    torch.cuda.synchronize()
                    stats = max(chip_smoke.rel_err(s, sr),
                                chip_smoke.rel_err(q, qr))
                    if route == "tc":
                        y_err = chip_smoke.ulp_err(torch, y, yr)
                        ok = y_err <= 2 and (
                            name in TIME_ONLY
                            or stats <= chip_smoke.CONV_STATS_TOL_16)
                        err_txt = f"y {y_err:.2f} ulp, stats rel {stats:.1e}"
                    else:
                        y_err = chip_smoke.rel_err(y, yr)
                        tol = chip_smoke.CONV_TF32X3_TOL
                        ok = y_err <= tol and (name in TIME_ONLY
                                               or stats <= tol)
                        err_txt = (f"y rel {y_err:.2e}, stats rel "
                                   f"{stats:.2e}")
                    ms = chip_smoke.device_ms(run)
                    flops = 2.0 * 9 * m * shape[3] * cout
                    l2 = l2_bytes(route, m, shape[3], cout, tiles)
                    rows.append({"shape": list(shape), "tiles": list(tiles),
                                 "rule": tiling == "rule", "ms": ms,
                                 "tflops": flops / ms / 1e9, "l2_bytes": l2,
                                 "y_err": y_err, "stats_rel": stats,
                                 "ok": ok, "ptxas": usage})
                    print(f"{tag:24s} {str(shape):22s} tiles "
                          f"{str(tiles):11s}"
                          f"{' (rule)' if tiling == 'rule' else '       '} "
                          f"{ms:.4f} ms device, {flops / ms / 1e9:.1f} "
                          f"TFLOP/s, tiles from L2 {l2 / 1e6:.1f} MB = "
                          f"{l2 / ms / 1e9:.2f} TB/s; {ms / cudnn:.2f}x "
                          f"cuDNN ({cudnn:.4f} ms); {err_txt} "
                          f"{'ok' if ok else 'WRONG'}", flush=True)
        del cases
        torch.cuda.empty_cache()
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
