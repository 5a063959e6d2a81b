#!/usr/bin/env python3
"""Time design variants of the port's s8 wgmma GEMM core (K5's conv on
route "wgmma") at ResNet-18 v1's 11 conv shapes, N = 128.

    python3 tools/torch_k5_variants.py [--variants a,b,...]
        [--warpgroups rule,1,2] [--modes int32,requant,range] [--probe]
        [--out PATH]

Needs one CUDA card and nvcc. Each variant is the committed
``mxnet_tpu_torch/csrc/s8_gemm_wgmma.cu`` with a few lines replaced, built
with the port's nvcc flags (and ``csrc/`` on the include path, for its
headers) into ``mxnet_tpu_torch/_build/`` and loaded in the committed
library's place, so ``ops.quantization``'s wrappers launch it. For every
shape it prints, once, the pre-pass's device time (``_s8_conv_prepare``;
and its weight part alone), ``torch._int_mm`` on the same im2col'd GEMM
and csrc/s8_gemm.cu (route "mma_s8") on the same inputs; then per variant
and
per consumer-warpgroup count (1, 2: 64 or 128 output channels a CTA;
"rule" is the wrapper's: ``_s8_warpgroups``'s for int32, 1 for a fused
mode) and per epilogue mode (``--modes``: int32; requant, relu and a
calibrated requantize, int8 out; range, the int32 and its batch range)
the product's device time (``_s8_conv_product`` on the pre-pass's
operands, chip_smoke.device_ms) with its int8 TOP/s, whether the output
equals the plain version bitwise (float64 conv; for the fused modes then
relu and ``requant_epilogue_reference`` or ``requant_range_reference``;
not for time-only variants; a count the source refuses is reported as
refused), ptxas's registers and
spills, the card's name and its power limit. Sums over the 20 convs of
one predict close the table. ``--probe`` adds, outside the sums, the three
stride-2 3x3 convs' GEMMs (M, N and K) as stride-1 convs on their output's
side. A variant that fails to build is reported and skipped. Variants:

  committed      the source as it is (persistent: one CTA for each slot
                 the card holds, tiles dealt round-robin)
  one_wave       one CTA a tile, as many as there are tiles
  stages2        2 ring stages
  stages8        up to 8 ring stages, as many as fit (4 committed)
  no_stores      the epilogue's NCHW stores left out (time only)
  no_mma         the products left out (time only): loads, ring and stores
  fused_wgs2     the fused modes also on two consumer warpgroups
  fused_wgs2_cta1  the same with one CTA an SM (__launch_bounds__ min 1:
                 no register cap of 96)
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 128
SOURCE = "s8_gemm_wgmma"
STAGES = ("  static constexpr int STAGES = FIT > 4 ? 4 : FIT < 2 ? 2 : "
          "FIT;")
GRID = ("  const int grid = int(n_tiles < sms * per_sm ? n_tiles : sms * "
        "per_sm);")
STORE = "            if (co0 + r < gm.cols)\n              store("
PAIR = ("          if (n0 + 8 * j + 2 * c < gm.rows)\n"
        "            store2(")
MMA = ("        wgmma_s8<BN>(acc, smem_desc(a + 32 * kk, lbo_a, K::SBO, "
       "K::LAYOUT),\n                     smem_desc(b + 32 * kk, lbo_b, "
       "K::SBO, K::LAYOUT));")
FUSED_WGS = ("  if constexpr (EPI == EPI_INT32) {\n    if (wgs == 2)\n"
             "      return dispatch_cb<2, true, false, EPI>(cb, tb, ta, bias, "
             "out, gm, ep,\n                                              s);\n"
             "  }\n")
WGS_CHECK = "(epi != 0 && wgs != 1) || "
BOUNDS = "__launch_bounds__(Cfg<C, CB>::NT, 2)"
PROBES = ((256, 512, 7, 3, 1, 1, 0), (128, 256, 14, 3, 1, 1, 0),
          (64, 128, 28, 3, 1, 1, 0))


def _replace(old, new):
    def edit(text):
        if old not in text:
            raise SystemExit(f"the source no longer has the lines a variant "
                             f"replaces:\n{old}")
        return text.replace(old, new)
    return edit


VARIANTS = {
    "committed": [],
    "one_wave": [_replace(GRID, "  const int grid = int(n_tiles);")],
    "stages2": [_replace(STAGES, "  static constexpr int STAGES = 2;")],
    "stages8": [_replace(STAGES, "  static constexpr int STAGES = "
                                 "FIT > 8 ? 8 : FIT < 2 ? 2 : FIT;")],
    # the NCHW stores (even planes' pairs, odd planes' buffer) only for a
    # pixel or row that cannot exist
    "no_stores": [_replace(STORE, "            if (co0 + r < 0)\n"
                                  "              store("),
                  _replace(PAIR, "          if (n0 + 8 * j + 2 * c < 0)\n"
                                 "            store2(")],
    "no_mma": [_replace(MMA, "        (void)lbo_a;\n        (void)lbo_b;")],
    "fused_wgs2": [
        _replace(FUSED_WGS, "  if (wgs == 2)\n    return dispatch_cb<2, true, "
                            "false, EPI>(cb, tb, ta, bias, out, gm, ep, s);\n"),
        _replace(WGS_CHECK, "")],
}
VARIANTS["fused_wgs2_cta1"] = VARIANTS["fused_wgs2"] + [
    _replace(BOUNDS, "__launch_bounds__(Cfg<C, CB>::NT, 1)")]
TIME_ONLY = ("no_stores", "no_mma")


def build(name, text, build_dir, nvcc, flags):
    src = build_dir / f"k5_variant_{name}.cu"
    src.write_text(text)
    lib = build_dir / f"k5_variant_{name}.so"
    return lib, subprocess.Popen([nvcc, *flags, "-o", str(lib), str(src)],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants to time")
    ap.add_argument("--warpgroups", default="rule,1,2",
                    help="comma-separated warpgroup counts (rule, 1, 2)")
    ap.add_argument("--modes", default="int32",
                    help="comma-separated epilogue modes (int32, requant, "
                         "range)")
    ap.add_argument("--probe", action="store_true",
                    help="also time the stride-2 GEMMs as stride-1 convs")
    ap.add_argument("--out", help="also write the results to PATH as JSON")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    wgs_list = [w if w == "rule" else int(w)
                for w in args.warpgroups.split(",")]
    modes = args.modes.split(",")

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_k5_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import quantization as q

    card = chip_smoke.card_identity()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    base = (_build.CSRC / f"{SOURCE}.cu").read_text()
    jobs = {}
    for name in names:
        text = base
        for edit in VARIANTS[name]:
            text = edit(text)
        jobs[name] = build(name, text, _build.BUILD_DIR, _build._nvcc(),
                           [*_build.NVCC_FLAGS, "-I", str(_build.CSRC)])
    _build.build_all((SOURCE, "s8_gemm"))
    gen = torch.Generator(device="cuda").manual_seed(15)
    cases = []
    for cin, cout, hw, k, s, p, count in chip_smoke.R18_CONVS + (
            PROBES if args.probe else ()):
        x = chip_smoke.s8_rand(torch, gen, (N, cin, hw, hw))
        w = chip_smoke.s8_rand(torch, gen, (cout, cin, k, k))
        bias = torch.randint(-2 ** 20, 2 ** 20, (cout,), generator=gen,
                             device="cuda", dtype=torch.int32)
        st, pd, dl = (s, s), (p, p), (1, 1)
        shape = q._conv_shape(x, w, st, pd, dl, False)
        xp, wp, pk = q._s8_conv_prepare(x, w, shape)
        with chip_smoke.exact_f64_convs(torch):
            ref = q.s8_conv_reference(x, w, st, pd, dl, bias=bias)
        # the fused modes' scalars and plain results: the requantize's
        # calibrated range half the relu'd output's batch range
        real_in = torch.tensor(8.0, device="cuda")
        half = q.requant_range_reference(ref.clamp_min(0), real_in) / 2
        epis = {"int32": (("int32", False, None, None, None), (ref,)),
                "requant": (("requant", True, real_in, -half, half),
                            q.requant_epilogue_reference(
                                ref.clamp_min(0), real_in, -half, half)),
                "range": (("range", False, real_in, None, None),
                          (ref, q.requant_range_reference(ref, real_in)))}
        epis = {m: epis[m] for m in modes}
        m, kk = N * shape[-2] * shape[-1], cin * k * k
        kp = -(-kk // 8) * 8
        cols = F.unfold(x.half(), (k, k), padding=p, stride=s).transpose(
            1, 2).reshape(m, kk)
        cols = F.pad(cols, (0, kp - kk)).to(torch.int8).contiguous()
        wk = F.pad(w.reshape(cout, kk), (0, kp - kk)).contiguous()
        saved = q._s8_route
        q._s8_route = lambda *a, **kw: "mma_s8"
        try:
            mma_ms = chip_smoke.device_ms(
                lambda: q.s8_conv(x, w, st, pd, dl, bias=bias), n=10)
        finally:
            q._s8_route = saved
        wp_only = torch.empty_like(wp)

        def prep_w():
            with torch.cuda.device(w.device):
                q._call("s8_wgmma_prep", None, *x.stride(), *shape[:4],
                        shape[3], pk.fold, 1, 0, 0, w.data_ptr(),
                        *w.stride(),
                        cout, k, k, pk.cp, pk.kpad, None, wp_only.data_ptr(),
                        q._stream(w))
        row = {"shape": [cin, cout, hw, k, s, p], "count": count,
               "ops": 2.0 * m * cout * kk,
               "prep_ms": chip_smoke.device_ms(
                   lambda: q._s8_conv_prepare(x, w, shape)),
               "prep_w_ms": chip_smoke.device_ms(prep_w),
               "int_mm_ms": chip_smoke.device_ms(
                   lambda: torch._int_mm(cols, wk.t())),
               "mma_s8_ms": mma_ms}
        del cols, wk
        print(f"{str(row['shape']):28s} x{count}: pre-pass "
              f"{row['prep_ms']:.4f} ms (its weight part alone "
              f"{row['prep_w_ms']:.4f}), torch._int_mm "
              f"{row['int_mm_ms']:.4f}, mma_s8 {row['mma_s8_ms']:.4f}",
              flush=True)
        cases.append((row, x, w, bias, shape, xp, wp, pk, epis))
    results = {"card": card, "shapes": [c[0] for c in cases],
               "variants": {}}
    for name in names:
        lib_path, proc = jobs[name]
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"{name:12s} failed to build:\n{out}", flush=True)
            results["variants"][name] = {"build_error": out[-2000:]}
            continue
        usage = [f"{e}: {u}" for e, u in chip_smoke.ptxas_usage(out)
                 if "wgmma_kernel" in e]
        spills = [u for u in usage if not
                  "0 bytes spill stores, 0 bytes spill loads" in u]
        print(f"{name:12s} ptxas: {len(usage)} kernels, max registers "
              f"{max(int(u.split('Used ')[1].split()[0]) for u in usage)}"
              f", spills: {spills or 'none'}", flush=True)
        _build._libs[SOURCE] = ctypes.CDLL(str(lib_path))
        rows = results["variants"][name] = []
        totals = {}
        for row, x, w, bias, shape, xp, wp, pk, epis in cases:
            for (mode, (epi, want)), wgs in (
                    (e, g) for e in epis.items() for g in wgs_list):

                def run():
                    return q._s8_conv_product(
                        xp, wp, pk, bias, shape,
                        warpgroups=None if wgs == "rule" else wgs,
                        epilogue=epi)
                try:
                    got = run()
                except q.MXNetError as e:
                    print(f"{name:12s} {str(row['shape']):28s} {mode:7s} "
                          f"wgs {wgs!s:4s} refused: {e}", flush=True)
                    continue
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                exact = all(torch.equal(a.view(torch.int32) if
                                        a.dtype == torch.float32 else a,
                                        b.view(torch.int32) if
                                        b.dtype == torch.float32 else b)
                            for a, b in zip(got, want))
                ms = chip_smoke.device_ms(run)
                ok = exact or name in TIME_ONLY
                rows.append({"shape": row["shape"], "mode": mode,
                             "warpgroups": wgs, "ms": ms, "exact": exact,
                             "tops": row["ops"] / ms / 1e9})
                key = (mode, wgs)
                totals[key] = totals.get(key, 0.0) + ms * row["count"]
                print(f"{name:12s} {str(row['shape']):28s} {mode:7s} "
                      f"wgs {wgs!s:4s} "
                      f"{ms:.4f} ms ({row['ops'] / ms / 1e9:.0f} TOP/s), "
                      f"+ pre-pass {ms + row['prep_ms']:.4f} vs _int_mm "
                      f"{row['int_mm_ms']:.4f}; exact {exact} "
                      f"{'ok' if ok else 'WRONG'}", flush=True)
        prep = sum(r[0]["prep_ms"] * r[0]["count"] for r in cases)
        int_mm = sum(r[0]["int_mm_ms"] * r[0]["count"] for r in cases)
        print(f"{name:12s} sums over the 20 convs: " + ", ".join(
            f"{m} wgs {g} {v:.4f} ms" for (m, g), v in totals.items()) +
            f"; pre-pass {prep:.4f}, _int_mm {int_mm:.4f}", flush=True)
    _build._libs.pop(SOURCE, None)
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
