#!/usr/bin/env python3
"""Time design variants of the port's tensor-core flash-attention backward
(K2).

    python3 tools/torch_k2_variants.py [--out PATH]

Needs one CUDA card and nvcc. Each variant is the committed
``mxnet_tpu_torch/csrc/flash_attn_bwd_tc.cu`` with a few lines replaced,
built with the port's nvcc flags (and ``csrc/`` on the include path, for
``hopper.cuh``) into ``mxnet_tpu_torch/_build/`` and run through
``ops.kernels.flash_attention_backward`` on the LM's shape
(8, 12, 1024, 64), bf16, causal, in the LM's layout (q/k/v views of one
qkv buffer, K1's O, a strided dO). For each variant it prints ptxas's
registers and spills for the bf16 D=64 kernels, the largest error of dq,
dk and dv in output ulps against the plain version, and the device time
(chip_smoke.device_ms), beside torch SDPA's backward, the card's name and
its power limit. Variants:

  committed     the source as it is
  dkdv_only     the dq kernel not launched (pre-pass + dk/dv; time only)
  dq_only       the dk/dv kernel not launched (pre-pass + dq; time only)
  not_split     p^T, ds^T and ds rounded once to bf16 (no lo terms)
  stages2       rings of 2 stages in both kernels
  bq64          dk/dv streams 64 queries a tile at D = 64 (32 committed)
  two_wg        two consumer warpgroups (128 rows) a CTA in both kernels
                at D = 64, one CTA per SM (one committed, two CTAs per SM)
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DKDV_LAUNCH = ("  dkdv<<<dim3(bh, t_pad / kv_rows<D>()), kv_threads<D>(), "
               "dkdv_smem<D>(),\n"
               "         stream>>>(maps[0], maps[1], maps[2], maps[3], p);")
DQ_LAUNCH = ("  dq<<<dim3(bh, t_pad / q_rows<D>()), q_threads<D>(), "
             "dq_smem<D>(),\n"
             "       stream>>>(maps[0], maps[1], maps[2], maps[3], p);")
CFG64 = """struct Cfg<64> {
  static constexpr int BQ = 32, KV_WGS = 1, KV_STAGES = 4;
  static constexpr int Q_WGS = 1, Q_STAGES = 3;"""
CFG128 = """struct Cfg<128> {
  static constexpr int BQ = 32, KV_WGS = 1, KV_STAGES = 4;
  static constexpr int Q_WGS = 2, Q_STAGES = 3;"""
VARIANTS = {
    "committed": [],
    "dkdv_only": [(DQ_LAUNCH, "")],
    "dq_only": [(DKDV_LAUNCH, "")],
    "not_split": [
        ("        wgmma_rs<D, F16>(dv, plo[kk], bd);\n", ""),
        ("        wgmma_rs<D, F16>(dk, dlo[kk], bq);\n", ""),
        ("        wgmma_rs<D, F16>(dq, dlo[kk], bk);\n", "")],
    "stages2": [
        (CFG64, CFG64.replace("STAGES = 4", "STAGES = 2")
         .replace("STAGES = 3", "STAGES = 2")),
        (CFG128, CFG128.replace("STAGES = 4", "STAGES = 2")
         .replace("STAGES = 3", "STAGES = 2"))],
    "bq64": [(CFG64, CFG64.replace("BQ = 32", "BQ = 64"))],
    "two_wg": [(CFG64, CFG64.replace("KV_WGS = 1", "KV_WGS = 2")
                .replace("Q_WGS = 1, Q_STAGES = 3",
                         "Q_WGS = 2, Q_STAGES = 4"))],
}
PARTIAL = {"dkdv_only": (1, 2), "dq_only": (0,)}   # the grads they compute


def build(name, text, build_dir, nvcc, flags):
    src = build_dir / f"k2_variant_{name}.cu"
    src.write_text(text)
    lib = build_dir / f"k2_variant_{name}.so"
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
        print("torch_k2_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from mxnet_tpu_torch.ops import _build, kernels

    card = chip_smoke.card_identity()
    base = (_build.CSRC / "flash_attn_bwd_tc.cu").read_text()
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
    gen = torch.Generator(device="cuda").manual_seed(13)
    q, k, v, out, lse, dout, _ = chip_smoke.bwd_inputs(
        torch, kernels, gen, shape, torch.bfloat16, "qkv", True, 0, 0, False)
    ref = kernels.flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                     causal=True)
    flops, _ = chip_smoke.attention_bwd_work(*shape, True, 2)
    results = {"card": card, "shape": list(shape), "variants": {}}
    for name, (lib_path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name:12s} failed to build:\n{log}", flush=True)
            results["variants"][name] = {"build_failed": log[-4000:]}
            continue
        usage = [f"{e}: {u}" for e, u in chip_smoke.ptxas_usage(log)
                 if "bfloat16, 64>" in e or name == "committed"]
        kernels._bwd_tc_library = lambda route, lib=ctypes.CDLL(
            str(lib_path)): lib

        def run():
            return kernels.flash_attention_backward(q, k, v, out, lse, dout,
                                                    causal=True)
        got = run()
        torch.cuda.synchronize()
        which = PARTIAL.get(name, (0, 1, 2))
        ulp = max(chip_smoke.ulp_err(torch, got[i], ref[i]) for i in which)
        ms = chip_smoke.device_ms(run)
        results["variants"][name] = {"ms": ms, "ulp": ulp, "ptxas": usage,
                                     "grads_checked": list(which)}
        print(f"{name:12s} {ms:.4f} ms device ({flops / ms / 1e9:.1f} "
              f"TFLOP/s of the five products), grads {which} within "
              f"{ulp:.2f} ulp; ptxas {' | '.join(usage) or '?'}", flush=True)
    leaves = [x.detach().contiguous().requires_grad_(True) for x in (q, k, v)]
    o_sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa = chip_smoke.device_ms(lambda: torch.autograd.grad(
        o_sdpa, leaves, dout, retain_graph=True))
    results["sdpa_bwd_ms"] = sdpa
    print(f"torch SDPA backward {sdpa:.4f} ms device")
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
