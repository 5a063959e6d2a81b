#!/usr/bin/env python3
"""K3's trainable wrapper against the unfused path on the card (the port of
tools/bench_fused_conv_bn.py).

Both paths compute the training segment ``relu(batch_norm(conv3x3(x, w)))``
with batch statistics, and its backward:

- unfused: ``ops.nn.convolution`` (cuDNN, NHWC), ``ops.nn.batch_norm`` in
  training (single-pass f32 moments), relu; backward through autograd --
  the path ResNet-50's training step runs;
- K3: ``ops.kernels.conv3x3_bn_relu_train``: the fused conv + statistics
  kernel, the normalise fold and relu; its backward in plain ops.

It runs chip_smoke.py's phase k at the given batch and shapes: outputs,
statistics and gradients checked against each other and against f32, every
K3 launch on the tensor-core route, forward and forward + backward in
device time, and the difference weighted by the number of convs of each
shape. One JSON line at the end.

    python3 tools/torch_bench_fused_conv_bn.py              # N=256, 4 shapes
    python3 tools/torch_bench_fused_conv_bn.py --n 64 --hw 28 --c 128
    python3 tools/torch_bench_fused_conv_bn.py --step-ms 250  # step share
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256, help="batch")
    ap.add_argument("--hw", type=int, help="one shape: H = W")
    ap.add_argument("--c", type=int, help="one shape: Cin = Cout")
    ap.add_argument("--step-ms", type=float,
                    help="a training step's time, to state the share")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_bench_fused_conv_bn: needs a CUDA device",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from mxnet_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = None
    if args.hw or args.c:
        if not (args.hw and args.c):
            ap.error("--hw and --c go together")
        shapes = [((args.hw, args.c), 1)]
    chip_smoke.log(chip_smoke.card_identity())
    out = chip_smoke.k3_at_training_shapes(torch, kernels, args.n,
                                           args.step_ms, shapes)
    print(json.dumps({"metric": "k3_train_vs_unfused",
                      "device": torch.cuda.get_device_name(0),
                      "card": chip_smoke.card_identity(), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
