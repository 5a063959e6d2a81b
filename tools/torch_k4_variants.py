#!/usr/bin/env python3
"""Time design variants of K4's int8 route (paged decode attention over
whole int8 pages by bulk copy).

    python3 tools/torch_k4_variants.py [--out PATH]

Needs one CUDA card and nvcc. Runs route "int8_bulk"
(``mxnet_tpu_torch/csrc/paged_decode_attn_int8.cu``) through
``ops.decode_attention.paged_decode_attention`` at chip_smoke.py's phase c
shape: B=32 slots, H=12, D=64, pages of 16, 64 pages a row, bf16 q, the
12 layers' int8 pools rotated so none is hot in L2; every row 1024 tokens
long, and every row at phase n's profiled position (353 tokens). For each
variant it prints the device time at both lengths (chip_smoke.device_ms),
the share of the bytes bound, the error against the plain version and,
for a rebuilt source, ptxas's registers and spills; beside the
one-element-a-lane kernel (route "int8") on the same pools, the card's
name and its power limit. Variants:

  committed          the route as it is (3 stages, 1 CTA an SM)
  stages2, stages4   rings of 2 and 4 pages (``STAGES`` in the source),
                     rebuilt
  ctas2, ctas4       split rules aiming at 2 and 4 CTAs an SM
                     (``_INT8_CTAS_PER_SM``); ctas2_stages2 the first with
                     rings of 2 pages, rebuilt
  consumers6         6 consumer warps a CTA (no warp splits a page's
                     tokens), rebuilt
  copies_only        the pages copied and waited for, no arithmetic (time
                     only), rebuilt; also with rings of 6 pages
                     (copies_only_stages6) and 2 CTAs an SM
                     (copies_only_ctas2)
  copies_chunked     each K and V page moved as 4 bulk copies of a
                     quarter page (D=64 pages of 16: 3 KB), rebuilt
  contiguous_ranges  split s takes the row's entries [s per, s per + per),
                     per = ceil(max_pages / splits), in the place of the
                     round-robin deal, rebuilt
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = "paged_decode_attn_int8"
LOOP = "    for (int t = 0; t < n_tok; t += 2 * groups) {"
NO_MATH = "    for (int t = n_tok; t < n_tok; t += 2 * groups) {"
STAGES = "constexpr int STAGES = 3; "


def stages(n):
    return (STAGES, f"constexpr int STAGES = {n}; ")


KV_COPIES = """    bulk_load(st, kp + page * g.page_bytes, g.page_bytes, &full[s]);
    bulk_load(st + g.page_bytes, vp + page * g.page_bytes, g.page_bytes,
              &full[s]);"""
RANGES = [("""  const int n_my = split < n_pages ? (n_pages - split + splits - 1) / splits
                                    : 0;""",
           """  const int per = (max_pages + splits - 1) / splits, p0 = split * per;
  const int n_my = max(0, min(p0 + per, n_pages) - p0);"""),
          ("table + (long long)b * max_pages + split, n_my, splits, P);",
           "table + (long long)b * max_pages + p0, n_my, 1, P);"),
          ("len, split, n_my, splits, scale,", "len, p0, n_my, 1, scale,")]
KV_CHUNKS = """    for (int k = 0; k < 4; ++k) {
      const int q4 = g.page_bytes / 4;
      bulk_load(st + k * q4, kp + page * g.page_bytes + k * q4, q4,
                &full[s]);
      bulk_load(st + g.page_bytes + k * q4,
                vp + page * g.page_bytes + k * q4, q4, &full[s]);
    }"""
VARIANTS = {
    "committed": ({}, []),
    "stages2": ({}, [stages(2)]),
    "stages4": ({}, [stages(4)]),
    "ctas2": ({"_INT8_CTAS_PER_SM": 2}, []),
    "ctas2_stages2": ({"_INT8_CTAS_PER_SM": 2}, [stages(2)]),
    "ctas4": ({"_INT8_CTAS_PER_SM": 4}, []),
    "consumers6": ({}, [("constexpr int MAX_CONSUMERS = 12;",
                         "constexpr int MAX_CONSUMERS = 6;")]),
    "copies_only": ({}, [(LOOP, NO_MATH)]),
    "copies_only_stages6": ({}, [(LOOP, NO_MATH), stages(6)]),
    "copies_only_ctas2": ({"_INT8_CTAS_PER_SM": 2}, [(LOOP, NO_MATH)]),
    "copies_chunked": ({}, [(KV_COPIES, KV_CHUNKS)]),
    "contiguous_ranges": ({}, RANGES),
}
TIME_ONLY = ("copies_only", "copies_only_stages6", "copies_only_ctas2")


def build(name, text, build_dir, nvcc, flags):
    src = build_dir / f"k4_variant_{name}.cu"
    src.write_text(text)
    lib = build_dir / f"k4_variant_{name}.so"
    return lib, subprocess.Popen([nvcc, *flags, "-o", str(lib), str(src)],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to PATH as JSON")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_k4_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import decode_attention as da

    card = cs.card_identity()
    base = (_build.CSRC / f"{SOURCE}.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name, (_, reps) in VARIANTS.items():
        if not reps:
            continue
        text = base
        for old, new in reps:
            if old not in text:
                raise SystemExit(f"variant {name}: the source no longer has "
                                 f"the lines it replaces:\n{old}")
            text = text.replace(old, new)
        texts[name] = text
    jobs = {name: build(name, text, _build.BUILD_DIR, _build._nvcc(),
                        [*_build.NVCC_FLAGS, "-I", str(_build.CSRC)])
            for name, text in texts.items()}
    committed = _build.load(SOURCE)

    b, h, d, ps, mp = 32, cs.HEADS, cs.UNITS // cs.HEADS, cs.DECODE_PS, 64
    pages = b * mp + 1
    gen = torch.Generator(device="cuda").manual_seed(43)
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    lengths = {"full": [mp * ps] * b,
               "step": [cs.DECODE_STEP_POSITION + 1] * b}
    table, _ = cs.decode_table(torch, gen, lengths["full"], ps, mp, pages)
    lens = {k: torch.tensor(v, dtype=torch.int32, device="cuda")
            for k, v in lengths.items()}
    bound = {k: cs.decode_work(v, b, h, d, mp, 1, 2, True)[1] /
             cs.PEAK_BYTES * 1e3 for k, v in lengths.items()}
    pools = [cs.decode_pool(torch, da, gen, pages, ps, h, d, True)
             for _ in range(cs.LAYERS)]
    ref = da.paged_decode_attention_reference(
        q, *pools[0][:2], table, lens["full"], k_scales=pools[0][2],
        v_scales=pools[0][3])
    scale = 1.0 / math.sqrt(d)
    turn = [0]

    def rotate(which, route=None):
        def call():
            kp, vp, ks, vs = pools[turn[0] % cs.LAYERS]
            turn[0] += 1
            return da._launch(q, kp, vp, table, lens[which], scale, ks, vs,
                              route=route)
        return call

    def measure(route=None):
        got = da._launch(q, *pools[0][:2], table, lens["full"], scale,
                         *pools[0][2:], route=route)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item() / \
            ref.float().abs().max().item()
        return {k: cs.device_ms(rotate(k, route), n=24) for k in lengths}, \
            err

    results = {"card": card, "shape": [b, h, d, ps, mp],
               "bound_ms": bound, "variants": {}}
    for name, (consts, reps) in VARIANTS.items():
        usage = ""
        saved = {c: getattr(da, c) for c in consts}
        for c, v in consts.items():
            setattr(da, c, v)
        if reps:
            lib_path, proc = jobs[name]
            out, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"variant {name} failed to build:\n{out}")
            usage = "; ".join(u for e, u in cs.ptxas_usage(out)
                              if "int8_kernel" in e and "bfloat16" in e)
            _build._libs[SOURCE] = ctypes.CDLL(str(lib_path))
        da._int8_geometry.cache_clear()    # the variant's own geometry
        try:
            ms, err = measure()
        finally:
            for c, v in saved.items():
                setattr(da, c, v)
            _build._libs[SOURCE] = committed
            da._int8_geometry.cache_clear()
        results["variants"][name] = {"ms": ms, "rel_err": err,
                                     "ptxas": usage}
        err_s = "time only" if name in TIME_ONLY else f"err {err:.2e}"
        print(f"{name:12s} full {ms['full']:.4f} ms "
              f"({bound['full'] / ms['full']:.1%} of bound), step position "
              f"{ms['step']:.4f} ms ({bound['step'] / ms['step']:.1%}); "
              f"{err_s}{'; ptxas ' + usage if usage else ''}", flush=True)
    for route in ("int8",):
        ms, err = measure(route)
        results[f"route_{route}"] = {"ms": ms, "rel_err": err}
        print(f"route {route:6s} full {ms['full']:.4f} ms, step position "
              f"{ms['step']:.4f} ms; err {err:.2e}", flush=True)
    print(f"bytes bound: full {bound['full']:.4f} ms, step position "
          f"{bound['step']:.4f} ms")
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
