#!/usr/bin/env python3
"""Time design variants of the port's fp32 flash-attention kernels on
their 3xTF32 route (K1 and K2, route "tf32x3").

    python3 tools/torch_tf32x3_variants.py [--out PATH]

Needs one CUDA card and nvcc. Each variant is the committed
``mxnet_tpu_torch/csrc/flash_attn_fwd_tf32x3.cu`` or
``flash_attn_bwd_tf32x3.cu`` with a few lines replaced, built with the
port's nvcc flags (and ``csrc/`` on the include path, for ``hopper.cuh``)
into ``mxnet_tpu_torch/_build/`` and run through ``ops.kernels`` on the
LM's shape (8, 12, 1024, 64), fp32, causal, in the LM's layout (q/k/v
views of one qkv buffer, K1's O, a strided dO). For each variant it prints
ptxas's registers and spills for the D=64 kernels, the largest error
against the plain version (O absolute; dq, dk, dv of max|ref|) and the
device time (chip_smoke.device_ms), beside torch SDPA in fp32, the card's
name and its power limit. Variants:

  committed   the sources as they are
  one_pass    one TF32 pass (hi x hi) per product: the split passes still
              run, the lo products do not (time and the error it costs)
  stages3     rings of 3 stages at D = 64 (2 committed)
  k1_bk32     K1 with K/V tiles of 32 keys at D = 64 (64 committed)
  dkdv_only   K2 without its dq kernel (time only)
  dq_only     K2 without its dk/dv kernel (time only)
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

K1_CFG64 = """template <> struct Cfg<64> {
  static constexpr int WGS = 2, BK = 64, STAGES = 2;"""
K2_CFG64 = """template <> struct Cfg<64> {
  static constexpr int BOX = 32, KV_WGS = 2, Q_WGS = 2, STAGES = 2;"""
K1_ONE_PASS = [
    ("        wgmma_ss_tf32<BK>(sc, sw128_desc(sql + qo, 16, 1024), kh, "
     "kk > 0);\n", ""),
    ("        wgmma_ss_tf32<BK>(sc, qh, sw128_desc(skl + ko, 16, 1024), 1);\n",
     ""),
    ("        wgmma_ss_tf32<BK>(sc, qh, kh, 1);\n",
     "        wgmma_ss_tf32<BK>(sc, qh, kh, kk > 0);\n"),
    ("        wgmma_rs_tf32<D>(acc, plo[kk], vh);\n", ""),
    ("        wgmma_rs_tf32<D>(acc, phi[kk], t_desc<BK, D>(svt, kk, true));\n",
     "")]
K2_ONE_PASS = [
    ("    wgmma_ss_tf32<N>(d, sw128_desc(al + ao, 16, 1024), dbh, kk > 0);\n",
     ""),
    ("    wgmma_ss_tf32<N>(d, dah, sw128_desc(bl + bo, 16, 1024), 1);\n", ""),
    ("    wgmma_ss_tf32<N>(d, dah, dbh, 1);\n",
     "    wgmma_ss_tf32<N>(d, dah, dbh, kk > 0);\n"),
    ("    wgmma_rs_tf32<N>(d, alo[kk], bh);\n", ""),
    ("    wgmma_rs_tf32<N>(d, ahi[kk], t_desc<R, N>(bt, kk, true));\n", "")]
DKDV_LAUNCH = ("  dkdv<<<dim3(bh, n_kv), threads<Cfg<D>::KV_WGS>(), "
               "dkdv_smem<D>(),\n"
               "         stream>>>(maps[0], maps[1], maps[2], maps[3], p);")
DQ_LAUNCH = ("  dq<<<dim3(bh, n_q), threads<Cfg<D>::Q_WGS>(), dq_smem<D>(),\n"
             "       stream>>>(maps[0], maps[1], maps[2], maps[3], p);")
# (kernel, name): the lines each variant replaces
VARIANTS = {
    ("K1", "committed"): [],
    ("K1", "one_pass"): K1_ONE_PASS,
    ("K1", "stages3"): [(K1_CFG64, K1_CFG64.replace("STAGES = 2",
                                                    "STAGES = 3"))],
    ("K1", "k1_bk32"): [(K1_CFG64, K1_CFG64.replace("BK = 64", "BK = 32"))],
    ("K2", "committed"): [],
    ("K2", "one_pass"): K2_ONE_PASS,
    ("K2", "stages3"): [(K2_CFG64, K2_CFG64.replace("STAGES = 2",
                                                    "STAGES = 3"))],
    ("K2", "dkdv_only"): [(DQ_LAUNCH, "")],
    ("K2", "dq_only"): [(DKDV_LAUNCH, "")],
}
PARTIAL = {"dkdv_only": (1, 2), "dq_only": (0,)}   # the grads they compute
SOURCES = {"K1": "flash_attn_fwd_tf32x3", "K2": "flash_attn_bwd_tf32x3"}


def build(tag, text, build_dir, nvcc, flags):
    src = build_dir / f"tf32x3_variant_{tag}.cu"
    src.write_text(text)
    lib = build_dir / f"tf32x3_variant_{tag}.so"
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
        print("torch_tf32x3_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from mxnet_tpu_torch.ops import _build, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_identity()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for (kernel, name), reps in VARIANTS.items():
        text = (_build.CSRC / f"{SOURCES[kernel]}.cu").read_text()
        for old, new in reps:
            if old not in text:
                raise SystemExit(f"variant {kernel} {name}: the source no "
                                 f"longer has the lines it replaces:\n{old}")
            text = text.replace(old, new)
        jobs[kernel, name] = build(f"{kernel}_{name}", text, _build.BUILD_DIR,
                                   _build._nvcc(),
                                   [*_build.NVCC_FLAGS, "-I",
                                    str(_build.CSRC)])
    shape = (8, 12, 1024, 64)
    gen = torch.Generator(device="cuda").manual_seed(13)
    q, k, v, out, lse, dout, _ = chip_smoke.bwd_inputs(
        torch, kernels, gen, shape, torch.float32, "qkv", True, 0, 0, False)
    ref_o = kernels.flash_attention_reference(q, k, v, causal=True)
    ref_g = kernels.flash_attention_backward_reference(q, k, v, out, lse,
                                                       dout, causal=True)
    f_flops, _ = chip_smoke.attention_work(*shape, True, 4)
    b_flops, _ = chip_smoke.attention_bwd_work(*shape, True, 4)
    results = {"card": card, "shape": list(shape), "variants": {}}
    fwd_lib, bwd_lib = kernels._tc_library, kernels._bwd_tc_library
    for (kernel, name), (lib_path, proc) in jobs.items():
        log, _ = proc.communicate()
        tag = f"{kernel} {name}"
        if proc.returncode:
            print(f"{tag:14s} failed to build:\n{log}", flush=True)
            results["variants"][tag] = {"build_failed": log[-4000:]}
            continue
        usage = [f"{e}: {u}" for e, u in chip_smoke.ptxas_usage(log)
                 if "<64>" in e]
        lib = ctypes.CDLL(str(lib_path))
        if kernel == "K1":
            kernels._tc_library = lambda route, lib=lib: lib

            def run():
                return kernels.flash_attention(q, k, v, causal=True)
            err = (run() - ref_o).abs().max().item()
            flops, which = f_flops, "O"
        else:
            kernels._bwd_tc_library = lambda route, lib=lib: lib

            def run():
                return kernels.flash_attention_backward(q, k, v, out, lse,
                                                        dout, causal=True)
            got = run()
            which = PARTIAL.get(name, (0, 1, 2))
            err = max(chip_smoke.rel_err(got[i], ref_g[i]) for i in which)
            flops = b_flops
        torch.cuda.synchronize()
        ms = chip_smoke.device_ms(run)
        kernels._tc_library, kernels._bwd_tc_library = fwd_lib, bwd_lib
        results["variants"][tag] = {"ms": ms, "err": err, "ptxas": usage,
                                    "checked": which}
        print(f"{tag:14s} {ms:.4f} ms device ({flops / ms / 1e9:.1f} TFLOP/s"
              f" of the needed products), {which} error {err:.3e}; ptxas "
              f"{' | '.join(usage) or '?'}", flush=True)
    leaves = [x.detach().contiguous().requires_grad_(True) for x in (q, k, v)]
    o_sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True)
    results["sdpa_ms"] = chip_smoke.device_ms(
        lambda: F.scaled_dot_product_attention(*leaves, is_causal=True))
    results["sdpa_bwd_ms"] = chip_smoke.device_ms(lambda: torch.autograd.grad(
        o_sdpa, leaves, dout, retain_graph=True))
    print(f"torch SDPA fp32 {results['sdpa_ms']:.4f} ms, backward "
          f"{results['sdpa_bwd_ms']:.4f} ms device")
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
