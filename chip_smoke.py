#!/usr/bin/env python3
"""Drive the PyTorch port (mxnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --quick    # build + kernel checks (phase b) only

Phases, each failing loudly with a non-zero exit:

  (a) the card's name and power limit, as nvidia-smi reports them;
      then every CUDA kernel is built from csrc/ with nvcc (sm_90a);
  (b) each kernel against its plain PyTorch version on the card, on
      fixed cases, with the tolerance and its reason printed;
  (c) kernel, plain-version and library times at the slice's shape,
      beside the kernel's bound on the H100;
  (d) the slice: TransformerLM(impl='flash') at GPT-2-small widths in
      bf16, behind Predictor + BatchServer, served to concurrent
      requests; the kernel launch count must be 12 x predict calls;
  (e) a 2-layer fp32 model of the same widths with the kernel against the
      same model with plain attention.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. ``--summary PATH`` also writes the
measurements as JSON. Without CUDA the script exits 1 and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# GPT-2-small widths: the slice's model
VOCAB, UNITS, HEADS, LAYERS, T = 50257, 768, 12, 12, 1024
BATCH = 8


def log(*args):
    print(*args, flush=True)


def card_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def ptxas_usage(build_log):
    """[(kernel, 'Used N registers, ...')] from nvcc's -Xptxas -v output,
    kernel names demangled with c++filt where it exists."""
    entries, usages = [], []
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entries.append(m.group(1))
        elif "Used" in line and len(usages) < len(entries):
            usages.append(line.split(":", 1)[-1].strip())
    try:
        names = subprocess.run(["c++filt"], input="\n".join(entries),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = entries
    names = [re.sub(r"\(.*", "", n.replace("(anonymous namespace)::", "")
                    .replace("void ", "")) for n in names]
    return list(zip(names, usages))


def median_ms(fn, n=25, warmup=3):
    """Median over ``n`` CUDA-event-timed calls of ``fn`` after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def attention_work(b, h, t, d, causal, itemsize):
    """(FLOP, bytes) the attention forward needs for these inputs: the
    visible (query, key) pairs times 4*D, and q, k, v read once, O written
    once, lse (f32) written once."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4.0 * d * pairs * b * h
    nbytes = 4.0 * b * h * t * d * itemsize + 4.0 * b * h * t
    return flops, nbytes


# ------------------------------------------------------------------ phase b
def check_flash(torch, kernels):
    """K1 against its plain version on fixed cases. Returns the check
    records and the largest O error at the slice's shape."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    tol32 = (1e-4, 1e-4, "fp32: O and lse within 1e-4 (reordered f32 sums)")
    tol16 = (1e-2, 1e-3, "16-bit: O within 1e-2 (2-3 output ulps at "
             "|O| <= 1), lse within 1e-3 (f32)")
    cases = [
        # name, (B, H, T, D), dtype, causal, q_offset, k_offset
        ("fp32 causal", (2, 4, 256, 64), f32, True, 0, 0),
        ("fp32 non-causal", (2, 4, 256, 64), f32, False, 0, 0),
        ("fp32 causal D=128", (1, 2, 512, 128), f32, True, 0, 0),
        ("fp32 causal ragged T=1000", (2, 2, 1000, 64), f32, True, 0, 0),
        ("fp32 non-causal ragged T=1000", (1, 2, 1000, 64), f32, False, 0,
         0),
        ("fp32 causal q_offset=128", (1, 2, 256, 64), f32, True, 128, 0),
        ("fp32 causal whole-skip k_offset=128", (1, 2, 256, 64), f32, True,
         0, 128),
        ("fp32 causal D=80 (masked in D=128)", (1, 2, 300, 80), f32, True,
         0, 0),
        ("bf16 causal D=256", (1, 2, 256, 256), bf16, True, 0, 0),
        ("bf16 causal slice shape", (BATCH, HEADS, T, UNITS // HEADS), bf16,
         True, 0, 0),
        ("fp16 causal slice shape", (BATCH, HEADS, T, UNITS // HEADS), f16,
         True, 0, 0),
    ]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    records, slice_err = [], 0.0
    for name, shape, dtype, causal, qo, ko in cases:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        out, lse = kernels.flash_attention(q, k, v, causal=causal,
                                           return_lse=True, q_offset=qo,
                                           k_offset=ko)
        torch.cuda.synchronize()
        ref, ref_lse = kernels.flash_attention_reference(
            q, k, v, causal=causal, return_lse=True, q_offset=qo,
            k_offset=ko)
        o_err = (out.float() - ref.float()).abs().max().item()
        l_err = (lse - ref_lse).abs().max().item()
        o_tol, l_tol, why = tol32 if dtype == f32 else tol16
        ok = (out.shape == ref.shape and lse.shape == ref_lse.shape
              and math.isfinite(o_err) and o_err <= o_tol
              and l_err <= l_tol)
        if ko > qo:
            # rows before k_offset - q_offset see no key: O = 0 and
            # lse = -1e30 + log(1e-20), exactly
            blind = ko - qo
            want = torch.tensor(-1e30, dtype=torch.float32) + math.log(1e-20)
            ok = ok and bool((out[:, :, :blind] == 0).all()) and bool(
                (lse[:, :, :blind].cpu() == want).all())
        log(f"[b] {name:40s} {str(tuple(shape)):20s} O err {o_err:.3e} "
            f"(tol {o_tol:g})  lse err {l_err:.3e} (tol {l_tol:g})  "
            f"{'ok' if ok else 'FAIL'}  -- {why}")
        if not ok:
            raise SystemExit(f"phase b: flash_attention disagrees with its "
                             f"plain version on '{name}'")
        if shape == (BATCH, HEADS, T, UNITS // HEADS):
            slice_err = max(slice_err, o_err)
        records.append({"case": name, "o_err": o_err, "lse_err": l_err})
    return records, slice_err


# ------------------------------------------------------------------ phase c
def time_flash(torch, kernels):
    import torch.nn.functional as F

    shape = (BATCH, HEADS, T, UNITS // HEADS)
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    ms = median_ms(lambda: kernels.flash_attention(q, k, v, causal=True))
    plain_ms = median_ms(lambda: kernels.flash_attention_reference(
        q, k, v, causal=True, return_lse=True))
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    flops, nbytes = attention_work(*shape, True, 2)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[c] flash_attn_fwd bf16 {shape} causal: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library (torch SDPA) {library_ms:.4f} "
        f"ms, bound {bound_ms:.4f} ms by {bound_by} ({flops:.3e} FLOP, "
        f"{nbytes:.3e} B); kernel at {bound_ms / ms:.2%} of bound, "
        f"{flops / ms / 1e9:.2f} TFLOP/s")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
            "bytes": nbytes}


# ------------------------------------------------------------------ phase d
def serve_slice(torch, mx, kernels):
    import numpy as np

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    gen = torch.Generator(device="cuda").manual_seed(0)
    net = transformer.transformer_lm(
        vocab=VOCAB, units=UNITS, num_heads=HEADS, num_layers=LAYERS,
        max_len=T, impl="flash", prefix="tlm_")
    net.initialize(mx.init.Xavier(), generator=gen)   # default ctx: gpu(0)
    net.cast("bfloat16")
    t0 = time.perf_counter()
    pred = serving.Predictor.from_block(
        net, input_shapes={"data": (T,)}, batch_sizes=(1, 2, 4, 8))
    log(f"[d] model built (bf16, {LAYERS} layers, {UNITS} units, {HEADS} "
        f"heads, vocab {VOCAB}, T {T}); warmup of buckets {pred.buckets} "
        f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.RandomState(0)
    n_threads, per_thread = 4, 16
    requests = [[rng.randint(0, VOCAB, (1, T)).astype(np.int64)
                 for _ in range(per_thread)] for _ in range(n_threads)]
    results = [[None] * per_thread for _ in range(n_threads)]

    kernels.flash_attention.launches = 0
    serving.reset_stats()
    with serving.BatchServer(pred, max_batch_size=8,
                             batch_timeout_ms=5.0) as server:
        def client(i):
            futs = [server.submit(ids) for ids in requests[i]]
            for j, f in enumerate(futs):
                results[i][j] = f.result(timeout=600)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        wall = time.perf_counter() - t0
    launches = kernels.flash_attention.launches
    st = serving.stats()
    n_req = n_threads * per_thread
    if any(th.is_alive() for th in threads):
        raise SystemExit("phase d: a client thread did not finish")
    for row in results:
        for r in row:
            logits = r[0]
            if tuple(logits[0].shape) != (T, VOCAB):
                raise SystemExit(f"phase d: result shape {logits.shape}")
            if not bool(torch.isfinite(logits).all()):
                raise SystemExit("phase d: non-finite logits")
    calls = st["serving_predict_calls"]
    log(f"[d] served {n_req} requests from {n_threads} threads in "
        f"{st['serving_batches']} batches ({calls} predict calls, "
        f"{st['serving_padded_samples']} padded rows): "
        f"{n_req / wall:.3f} requests/s, {n_req * T / wall:.1f} tokens/s, "
        f"p50 {st['serving_p50_latency_us'] / 1e3:.2f} ms, "
        f"p99 {st['serving_p99_latency_us'] / 1e3:.2f} ms; "
        f"flash launches {launches}")
    if calls < 1 or launches != LAYERS * calls:
        raise SystemExit(f"phase d: {launches} flash launches for {calls} "
                         f"predict calls (want {LAYERS} per call)")

    # a request coalesced into one full batch equals its row of predict on
    # the same bucket, bitwise
    batch = [requests[0][j] for j in range(8)]
    with serving.BatchServer(pred, max_batch_size=8,
                             batch_timeout_ms=10000.0) as server:
        futs = [server.submit(ids) for ids in batch]
        served = [f.result(timeout=600)[0] for f in futs]
    direct = pred.predict(np.concatenate(batch, axis=0))[0]
    same = all(torch.equal(served[j][0], direct[j]) for j in range(8))
    log(f"[d] batched request == its row of predict (bucket 8): {same}")
    if not same:
        raise SystemExit("phase d: batched result differs from predict")
    breakdown = profile_predict(torch, pred, np.concatenate(batch, axis=0))
    del results, served, direct, pred, net
    torch.cuda.empty_cache()
    return {"breakdown": breakdown, "requests": n_req, "wall_s": wall,
            "requests_per_s": n_req / wall, "tokens_per_s": n_req * T / wall,
            "p50_ms": st["serving_p50_latency_us"] / 1e3,
            "p99_ms": st["serving_p99_latency_us"] / 1e3,
            "batches": st["serving_batches"], "predict_calls": calls,
            "launches": launches}


def profile_predict(torch, pred, ids):
    """Device time by kernel for one bucket-8 predict, from torch.profiler:
    where the slice's time goes."""
    from torch.profiler import ProfilerActivity, profile

    pred.predict(ids)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(ids)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    flash_ms = sum(r[0] for r in rows if "flash_fwd_kernel" in r[2])
    log(f"[d] profile of one bucket-8 predict: wall {wall_ms:.3f} ms "
        f"(profiler on), device busy {busy_ms:.3f} ms "
        f"({busy_ms / wall_ms:.1%} of wall), flash_fwd_kernel "
        f"{flash_ms:.3f} ms ({flash_ms / busy_ms:.1%} of device time)"
        if busy_ms else "[d] profile: no device time recorded (not measured)")
    for ms, count, key in rows[:8]:
        log(f"[d]   {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "flash_ms": flash_ms,
            "top": [{"ms": ms, "count": c, "kernel": k[:120]}
                    for ms, c, k in rows[:8]]}


# ------------------------------------------------------------------ phase e
def model_vs_plain(torch, mx):
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    gen = torch.Generator(device="cuda").manual_seed(3)
    nets = {}
    for impl in ("flash", "dense"):
        nets[impl] = transformer.transformer_lm(
            vocab=VOCAB, units=UNITS, num_heads=HEADS, num_layers=2,
            max_len=T, impl=impl, prefix="tlm_")
    nets["flash"].initialize(mx.init.Xavier(), generator=gen)
    nets["dense"].initialize(mx.init.Zero())
    nets["dense"].load_numpy_params(nets["flash"].collect_params())
    ids = torch.randint(0, VOCAB, (2, T), generator=gen, device="cuda")
    with torch.inference_mode():
        a = nets["flash"](ids)
        b = nets["dense"](ids)
    err = (a - b).abs().max().item()
    ok = bool(torch.isfinite(a).all()) and err <= 1e-3
    log(f"[e] 2-layer fp32 model, flash kernel vs plain attention: logits "
        f"max abs err {err:.3e} (tol 1e-3: reordered f32 sums through 2 "
        f"layers and a {UNITS}-wide head) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase e: model logits disagree")
    return err


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and run the kernel checks (phase b) only")
    ap.add_argument("--summary", metavar="PATH",
                    help="also write the measurements to PATH as JSON")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to drive",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _build, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_identity()
    log(card)
    log(f"[a] torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[a] built {', '.join(_build.SOURCES)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in _build.SOURCES:
        for entry, usage in ptxas_usage(_build.build_log(name)):
            log(f"[a] ptxas {entry}: {usage}")

    checks, slice_err = check_flash(torch, kernels)
    if args.quick:
        log("[quick] phase b passed; phases c-e skipped")
        return 0
    timing = time_flash(torch, kernels)
    served = serve_slice(torch, mx, kernels)
    model_err = model_vs_plain(torch, mx)

    record = {"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:149",
        "launches": served["launches"], "max_abs_err": slice_err,
        "check": f"{len(checks)} cases within tolerance",
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]}
    kind = torch.cuda.get_device_name(0)
    if args.summary:
        os.makedirs(os.path.dirname(os.path.abspath(args.summary)),
                    exist_ok=True)
        with open(args.summary, "w") as f:
            json.dump({"card": card, "kind": kind, "kernel_checks": checks,
                       "timing": timing, "slice": served,
                       "model_vs_plain_err": model_err, **record}, f,
                      indent=1)
    log(card)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
