#!/usr/bin/env python3
"""Time design variants of the port's tensor-core flash-attention kernel.

    python3 tools/torch_k1_variants.py [--out PATH]

Needs one CUDA card and nvcc. Each variant is the committed
``mxnet_tpu_torch/csrc/flash_attn_fwd_tc.cu`` with a few lines replaced,
built with the port's nvcc flags (and ``csrc/`` on the include path, for
``hopper.cuh``) into ``mxnet_tpu_torch/_build/`` and run
through ``ops.kernels.flash_attention`` on the LM's shape (8, 12, 1024, 64),
bf16, causal, q/k/v as strided views of one qkv buffer. For each variant
it prints ptxas's registers and spills, O's largest error in output ulps
against the plain version, and the device time (chip_smoke.device_ms),
beside torch SDPA's, the card's name and its power limit. Variants:

  committed          the source as it is
  p_not_split        P rounded once to bf16 before P.V (no lo term)
  bk128_one_cta      K/V tiles of 128 rows for D = 64, one CTA per SM
  one_wg_per_cta     64 query rows and one consumer warpgroup per CTA,
                     2 stages, four CTAs per SM
  no_qk_mma          the Q K^T products left out (time only)
  no_pv_mma          the P.V products left out (time only)
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

QK = """        wgmma_ss<BK, F16, 0>(
            sc, sw128_desc(qw + (kk / 4) * Q_PANEL + off, 16, 1024),
            sw128_desc(kt + (kk / 4) * KV_PANEL + off, 16, 1024), kk > 0);"""
PV = """        wgmma_rs<D, F16>(acc, phi[kk], dv);
        wgmma_rs<D, F16>(acc, plo[kk], dv);"""
VARIANTS = {
    "committed": [],
    "p_not_split": [(PV, "        wgmma_rs<D, F16>(acc, phi[kk], dv);")],
    "bk128_one_cta": [("static constexpr int BK = 64, MIN_BLOCKS = 2;",
                       "static constexpr int BK = 128, MIN_BLOCKS = 1;")],
    "one_wg_per_cta": [
        ("constexpr int BQ = 128;", "constexpr int BQ = 64;"),
        ("constexpr int CONSUMERS = 2;", "constexpr int CONSUMERS = 1;"),
        ("constexpr int STAGES = 3;", "constexpr int STAGES = 2;"),
        ("static constexpr int BK = 64, MIN_BLOCKS = 2;",
         "static constexpr int BK = 64, MIN_BLOCKS = 4;")],
    # the products' results replaced by values that keep the softmax busy
    "no_qk_mma": [(QK, "        if (kk == 0)\n"
                       "          for (int z = 0; z < BK / 2; ++z)\n"
                       "            sc[z] = float(z & 7);")],
    "no_pv_mma": [(PV, "        acc[kk] += __uint_as_float(phi[kk][0] ^ "
                       "plo[kk][3]) + float(dv & 1);")],
}


def build(name, text, build_dir, nvcc, flags):
    src = build_dir / f"k1_variant_{name}.cu"
    src.write_text(text)
    lib = build_dir / f"k1_variant_{name}.so"
    return lib, subprocess.Popen([nvcc, *flags, "-o", str(lib), str(src)],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to PATH as JSON")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_k1_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from mxnet_tpu_torch.ops import _build, kernels

    card = chip_smoke.card_identity()
    base = (_build.CSRC / "flash_attn_fwd_tc.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, reps in VARIANTS.items():
        text = base
        for old, new in reps:
            if old not in text:
                raise SystemExit(f"variant {name}: the source no longer has "
                                 f"the lines it replaces:\n{old}")
            text = text.replace(old, new)
        jobs[name] = build(name, text, _build.BUILD_DIR, _build._nvcc(),
                           [*_build.NVCC_FLAGS, "-I", str(_build.CSRC)])
    shape = (8, 12, 1024, 64)
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = chip_smoke.flash_inputs(torch, gen, shape, torch.bfloat16,
                                      "qkv")
    ref = kernels.flash_attention_reference(q, k, v, causal=True)
    results = {"card": card, "shape": list(shape), "variants": {}}
    for name, (lib_path, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{out}")
        usage = [u for e, u in chip_smoke.ptxas_usage(out)
                 if "bfloat16, 64>" in e]
        kernels._tc_library = lambda route, lib=ctypes.CDLL(
            str(lib_path)): lib
        got = kernels.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        ulp = chip_smoke.ulp_err(torch, got, ref)
        ms = chip_smoke.device_ms(lambda: kernels.flash_attention(
            q, k, v, causal=True))
        results["variants"][name] = {"ms": ms, "o_ulp": ulp,
                                     "ptxas": usage[0] if usage else ""}
        print(f"{name:16s} {ms:.4f} ms device, O {ulp:.2f} ulp; ptxas "
              f"{usage[0] if usage else '?'}", flush=True)
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    sdpa = chip_smoke.device_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True))
    results["sdpa_ms"] = sdpa
    print(f"torch SDPA       {sdpa:.4f} ms device")
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
