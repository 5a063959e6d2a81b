#!/usr/bin/env python3
"""Drive the PyTorch port (mxnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --quick    # build + kernel checks (phase b) only
    python3 chip_smoke.py --module-only   # build + phase r (mx.nd, Module)
    python3 chip_smoke.py --multirank-only   # build + phase o (4 ranks)
    python3 chip_smoke.py --int8-only        # build + K5's checks, phase p
                                             # and K5's timing
    python3 chip_smoke.py --amp-only         # build + phase q
    python3 chip_smoke.py --rnn-only         # build + phase s (word LM)
    python3 chip_smoke.py --lm-sweeps 6      # build + s1's LM, card and CPU
    python3 chip_smoke.py --ssd-only         # build + phase t (SSD)
    python3 chip_smoke.py --dist-only        # build + phase u (dist_sync)
    python3 chip_smoke.py --fleet-only       # build + phase v (serving)
    python3 chip_smoke.py --resilience-only  # build + phase w
    python3 chip_smoke.py --pod-only         # build + phase x (pod drills)

Phases, each failing loudly with a non-zero exit:

  (a) the card's name and power limit, as nvidia-smi reports them;
      then every CUDA kernel is built from csrc/ with nvcc (sm_90a), and
      ptxas's registers and spills printed (the tensor-core kernels,
      16-bit, 3xTF32 and int8, must not spill);
  (b) each kernel against its plain PyTorch version on the card, on
      fixed cases, with the tolerance and its reason printed: K1 (flash
      attention) on its three routes -- the tensor-core kernel (16-bit,
      D 64/128, contiguous or the LM's strided q/k/v, launched twice
      for bitwise equality), the 3xTF32 one (fp32, the same layouts,
      also launched twice) and the CUDA-core one (other D, misaligned
      bases) --, K2 (the flash backward, on its three routes -- the
      tensor-core kernel (wgmma + TMA; 16-bit, D 64/128), the 3xTF32 one
      (fp32, the same) and the CUDA-core one (other D, misaligned) --:
      ragged T, offsets, rows that see no key, dlse, the LM's
      strided layout; a second launch bitwise equal; the plain version
      without its dlse term must fail the check; dq, dk, dv written into
      the heads of a larger buffer whose other heads must keep a
      sentinel), the K1 + K2 autograd Function against autograd through
      dense attention, and the packed qkv Function (the LM's path: one
      d(qkv) buffer) against dense autograd and, bitwise, against the
      three-view Function --, K3
      (conv3x3 + BN statistics) on its three routes -- the tensor-core
      kernel (16-bit, channels in multiples of 64, every tile rule), the
      3xTF32 one (fp32, Cin in multiples of 32, Cout of 64: ResNet-50's
      shapes at N=32 and the edges, held to 1e-5 of max|ref|, which one
      TF32 pass must miss; its weight pre-pass bitwise) and the CUDA-core
      one (ragged channels, a misaligned base) --, a second launch
      bitwise equal for each route and tile rule, and K3's trainable
      wrapper's gradients against autograd --, and K4 (paged decode
      attention: csrc/paged_decode_attn.cu for fp32 pools and the int8
      pools it keeps, csrc/paged_decode_attn_int8.cu, route "int8_bulk",
      for int8 pools of D a multiple of 16 that are 16-byte aligned): fp32,
      bf16 and fp16 q over fp32 and int8 pools, shuffled page tables (some
      with other pages past each row's length), ragged lengths, D 64 and
      65, the slice's shape, a misaligned int8 pool, each on the route the
      rule names; fp32 q within 1e-5 of max|ref|, 16-bit q within 1 ulp of
      the plain version's rounded output, rows of length 0 exactly 0, a
      second launch bitwise equal, and no call of the plain version on a
      CUDA tensor; and the int8 KV write (csrc/kv_quantize_write.cu) on
      the qkv views in fp32, bf16 and fp16, bitwise equal to its plain
      version, every byte outside the written slots unchanged; and K5
      (csrc/s8_gemm_wgmma.cu, route "wgmma": s8 wgmma fed by TMA, its
      pre-pass laying the operands out; csrc/s8_gemm.cu, route "mma_s8";
      csrc/requant_int8.cu): the wgmma kernels' ptxas registers, shared
      memory and spills; the int8 conv on ResNet-18's 11 conv shapes at
      N=8 and on edges (Cin 5 with K = 45, odd H and W, dilation 2, a
      ragged M without bias, misaligned bases) on both routes, NHWC on
      "wgmma", the pre-pass bitwise equal to its plain version; the int8
      GEMM on the FC and on ragged rows on both routes, on K off a
      multiple of 16 and misaligned bases on the rule's "mma_s8"; int32
      exactly equal to the float64 plain versions (cuDNN off for them);
      requantize on both paths, bitwise equal, .5 ties included, a NaN
      range out NaN; requantize under the batch's own range, computed by
      the kernel (mode "own") or handed in (mode "given"), bitwise (a
      relu'd input, all zeros, an odd length, a NaN real_in); the conv's
      fused epilogues (s8_conv_requant: relu and a calibrated requantize
      to int8, or the int32 and its range word) bitwise equal to the plain
      chain on even and odd NCHW planes and NHWC, relu on and off, the NaN
      poison in both; every case launched twice, bitwise; a grouped int8
      conv must raise;
  (c) kernel, plain-version and library times at the slices' shapes, in
      device time, beside each kernel's bound on the H100 (K1 also on the
      strided layout, and in fp32 the 3xTF32 kernel beside the CUDA-core
      one, SDPA fp32 and the 3xTF32 bound; K2 beside torch SDPA's
      backward, also on the LM's layout, on the CUDA cores and in fp32
      (3xTF32) beside the CUDA-core route, SDPA's fp32 backward and the
      fp32 plain version, with the tensor-core work each really issues; K3
      also beside its CUDA-core kernel on the same inputs and the unfused
      cuDNN conv + batch_norm path, and in fp32 the 3xTF32 kernel with the
      TF32 work it issues beside the CUDA-core kernel, cuDNN's fp32 conv
      with TF32 off and on, and the fp32 unfused path; K4 at B=32, H=12,
      D=64, pages of 16, 1024 tokens a row (and at phase n's 353), fp32
      and int8 pools rotated over 12 layers' pools so none is hot in L2,
      the int8 pools on both int8 routes, beside its bytes bound, its
      plain version and one SDPA call over the same KV already contiguous,
      which takes no page table; the int8 write at the step's shape beside
      its plain chain and bound; K5, after phase p, on one eager walk of
      the unfused nodes of phase p's bucket-128 int8 graph: each of its 20
      convs, its FC and its 36 requantize calls held on the inputs the
      path gave it to the plain version (int32 exactly, requantize
      bitwise), the plan's 8 fused conv + relu + requantize calls bitwise
      to the plain chain and its 11 range words bitwise to the plain
      range (the requantize reading each bitwise too), then on those
      inputs each conv shape timed on route "wgmma" (its pre-pass and its
      product also apart) and on "mma_s8", in turns, beside its bound at
      the int8 tensor-core peak or the bytes, the float64 plain version,
      torch._int_mm on the same im2col'd GEMM and cuDNN's bf16 conv; the
      FC on both routes beside torch._int_mm; the fused predict's 28
      standalone requantize steps, each in its mode, on the path's inputs
      and on random int32, beside their bytes, and a sweep of input
      values (zeros, small, random); each fused conv against the unfused
      conv + relu + requantize it replaces);
  (d) the slice: TransformerLM(impl='flash') at GPT-2-small widths in
      bf16, behind Predictor + BatchServer, served to concurrent
      requests: each bucket captured as a CUDA graph at the predictor's
      warm-up (12 tensor-core K1 launches enqueued at each of its 2
      warm-up runs and its capture, none on the CUDA cores, none at a
      replay); one bucket-8 predict profiled, with its copy kernels
      counted;
  (e) a 2-layer model of the same widths with the kernel against the
      same model with plain attention, in fp32 (3xTF32) and in bf16;
  (f) ResNet-50 v1 (NHWC, s2d stem) at full depth and width in bf16,
      behind Predictor + BatchServer, served to 128 concurrent
      single-image requests, and one bucket-32 predict profiled;
  (g) K3 fed that model's own tensors (the 3x3 conv of each stage's first
      bottleneck): exactly 4 launches, all on the tensor-core route, each
      within tolerance of cuDNN's output and of the plain version; the same
      on an fp32 ResNet-50's tensors: exactly 4 launches, all on the 3xTF32
      route; no copy kernel per conv; and an fp32 NHWC ResNet-50 against
      the same weights in NCHW;
  (h) the training slice: the same LM at full width and depth in bf16,
      gluon.Trainer + Adam (lr 1e-3) + SoftmaxCrossEntropyLoss, 10 steps on
      one fixed batch (B=8, T=1024) of a learnable sequence: finite losses,
      loss 10 at least 0.5 below loss 1, exactly 12 tensor-core K1 and 12
      K2 launches a step; median step time and tokens/s; one more step
      profiled (forward + backward, and the Adam update), with fewer copy
      kernels than layers (the qkv projection's gradient is one buffer);
  (i) one training step of a 2-layer model of the same widths with K1 + K2
      against plain attention, in fp32 (both on route "tf32x3") and bf16
      (both "tc"): loss and every gradient;
  (j) ResNet-50 v1 (NHWC, s2d stem) at full depth and width trained as
      train_imagenet.py trains it: parallel.ShardedTrainer on one card,
      SGD (lr 0.1, momentum 0.9, wd 1e-4), bf16 compute over fp32 masters,
      20 steps on one fixed batch of 256 images: finite losses, the last at
      least 1.0 below the first, fp32 masters, momentum and running
      statistics, the running statistics moved; median step, images/s and
      peak memory; one more step profiled, and the SGD update alone; a
      microbatches=2 step against the fused step on each half; then
      sync_to_net and a predict-mode forward through Predictor;
  (k) K3's trainable wrapper (conv3x3_bn_relu_train) at ResNet-50's four
      stride-1 3x3 shapes at phase j's batch, bf16, against the path the
      model runs (cuDNN conv, batch_norm in training, relu; backward by
      autograd): outputs, statistics and gradients within tolerance of
      the same function in f32 and no further from it than the unfused
      path, every K3 launch on the tensor-core route, forward and
      forward + backward
      timed, and the difference weighted by the 16 convs set against phase
      j's step; then in fp32, a measurement: the wrapper on the 3xTF32
      route against the fp32 unfused path (cuDNN, TF32 off), forward and
      forward + backward, weighted by the 16 convs;
  (l) capture (mxnet_tpu_torch/capture.py, CUDA graphs): each route of
      K1, K2 and K3 captured alone and replayed on new inputs, bitwise
      equal to an eager launch (the 3xTF32 K1 one graph node, K2 and K3
      three each); phase h's LM step through
      capture.capture(trainer, net=, loss_fn=) and phase j's ResNet-50
      step through ShardedTrainer, each against the kill switch's eager
      step from one start (eager run twice: bitwise when eager repeats
      bitwise, else within eager's own spread), with median step ms,
      tokens/s or images/s, kernels per step (profiled) and the graph's
      kernel nodes (its DOT dump, kept in graphs/ beside the --summary
      file: 12 K1 and 12
      K2 nodes in the LM step), busy and wall time, capture time and peak
      memory; the LM bucket-8 and ResNet-50 bucket-32 predicts captured
      against eager (bitwise, p50, busy and wall, BatchServer
      requests/s; 12 K1 nodes in the LM bucket); no retrace and no eager
      run after warm-up; K4 on each route captured alone (2 nodes,
      replay on new tables and lengths bitwise);
  (m) the fp32 training slice: phase h's LM left in fp32 (mxnet_tpu's
      default dtype) at full width and depth, gluon.Trainer + Adam (lr
      1e-3), 10 steps on phase h's batch: finite losses, loss 10 at least
      0.5 below loss 1, exactly 12 K1 and 12 K2 launches a step, all on
      the 3xTF32 route; median step, tokens/s and peak memory; one more
      step profiled for K1's and K2's device ms and the busy time;
  (n) generative decode at the same widths (bf16 weights): DecodePredictor
      (pages of 16, 32 slots, 32 x 64 + 1 pages, prefill buckets 64-512)
      behind DecodeBatcher, 64 requests from 4 threads, seeded prompts of
      64-512 tokens, 128 new tokens each, twice with fp32 and twice with
      int8 KV in the order fp32, int8, int8, fp32: tokens/s, TTFT and inter-token p50/p99, pages at peak,
      preemptions, the pool's bytes; 12 K4 launches (int8 KV: route
      "int8_bulk") at each of the step's 2 warm-up runs and its capture and
      none after, 24 K4 nodes in the step graph; with int8 KV one write
      launch a layer in each prefill bucket and the step (12 nodes in each
      graph); no capture after warm-up; the step with 32 live slots timed
      and profiled (busy / wall, kernels, K4's and the write's share); then
      an fp32 copy of the
      model with fp32 KV: 4 prompts x 32 greedy tokens, every step's
      logits within 1e-3 of max|logits| of the flat forward's on the
      generated sequence;
  (o) training over several ranks on this one card: 4 rank processes
      (torch.multiprocessing, spawn) over a gloo group -- one card holds
      one NCCL rank -- with MXNET_TPU_TORCH_CAPTURE=0 (a CUDA graph cannot
      hold a host-staged collective); the one-rank references run first,
      here, and reach the ranks through files in _multirank/. (o1) the
      ring over {"sp": 4} at (2, 12, 4096, 64), bf16 (route "tc") and
      fp32 ("tf32x3"), causal and full: O, lse, dq, dk, dv against one
      whole-sequence K1 / K2 call and against their plain versions over
      the whole sequence (2e-2 / 1e-4 of max|ref|; the whole-sequence
      call is held to the plain versions too), 4 K1 and 4 K2 launches a
      rank on the named route, none plain, the staged bytes; every hop's
      K1 and K2 timed alone beside the whole-sequence call, its plain
      versions and one SDPA forward + backward over the whole sequence; (o2) phase h's LM (bf16 over fp32 masters, Adam) through
      ShardedTrainer over {"dp": 4}, 2 rows a rank: loss and gradients
      against the one-rank step (1e-2, 5e-2 of max|grad|), the weights
      after one step within 5e-2 of max|grad|, 10 steps losing >= 0.5,
      12 K1 + 12 K2 launches a step, step ms (eager, gloo); (o3) the same
      over {"dp": 2, "fsdp": 2} with SpecLayout's rules, and the bytes a
      rank holds; (o4) TransformerLM(impl='ring') over {"sp": 4}, 256
      tokens a rank, loss and gradients against impl='flash' on one rank:
      fp32 within 1e-5 / 1e-4 (the check), bf16 within 3e-2 and the
      unsplit bound of o2 (advisory), without and with remat (K1
      launched twice a hop); (o5) phase j's ResNet-50 over {"dp": 4}, 64
      images a rank, 2 steps against the one-rank steps at 256 (losses
      within 2^-8, running statistics after step 1 within 1e-3 of
      max(1, max|ref|): BatchNorm's statistics are the global batch's),
      step 2 again from the one-rank state after step 1 (loss within
      2^-8, statistics within 1e-3 or twice what the rows' order alone
      moves the one-rank step 2 from that state, + 1e-3), a
      per-rank-BatchNorm control that must miss the statistics' bound,
      and the one-rank steps on the rows permuted as the witness of how
      far rounding alone moves step 2; (o6) phase h's LM over {"tp": 4}
      with SpecLayout's rules (tensor parallelism: attention and FFN
      column- and row-parallel on each rank's heads and columns, the
      embedding and head gathered), all 8 rows on every rank: loss,
      gradients and the weights after one step (and after sync_to_net)
      against the unsplit one-rank step within o2's bounds, 12 K1 + 12 K2
      launches a step on route "tc" at (8, 3, 1024, 64), 48 tp
      all-reduces a step and their bytes, the bytes a rank holds, 10
      steps losing >= 0.5, step ms; then the same in fp32 (K1 and K2 on
      "tf32x3"), gradients within 1e-4 of max|grad| of the one-rank fp32
      step's, and the weights after one step and sync_to_net; (o7) the
      same over {"fsdp": 2, "tp": 2}, 4 rows a rank, against the one-rank
      step split into 2 microbatches of 4 rows, K1 / K2 at (4, 6, 1024,
      64). A rank that fails, or ranks that do not finish within
      MR_JOIN_S, fail the phase;
  (p) INT8 serving (before phase o): ResNet-18 v1 (224^2 NCHW, 1000
      classes, seeded Xavier) exported, then Predictor(sym_file,
      params_file, quantize="int8", naive calibration on 32 images,
      buckets 1, 32, 128): the graph's op counts (20 quantized convs, 36
      requantize, ...), the executor's plan (8 conv -> relu -> calibrated
      requantize chains, 11 conv -> batch-range requantize chains), K5's
      launches counted from just before the build to just after the first
      predict (a bucket program: 1 conv, 19 fused convs by mode, 1 FC, 28
      requantize by mode; every conv and the FC on route "wgmma", none on
      "mma_s8" or the plain versions), the bucket-128 graph's 21 s8_wgmma,
      20 pre-pass, 28 requant and 5 range-pass nodes, the captured fused
      predict's logits bitwise equal to the unfused walk's, int8 logits
      on 128 other images
      within 0.15 of max|fp32| of the folded fp32 graph with top-1
      agreement >= 0.75, a second predict bitwise, the bucket-128 logits
      bitwise equal to those of the same predict with the route rule
      patched to "mma_s8"; images/s at bucket 128 and p50 per bucket for
      fp32 (Symbol-fed), bf16 (Block-fed) and int8; one int8 predict
      profiled (K5's convs, their pre-pass, requantize, the other ops);
  (q) the training frontend (last): (q1) phase h's LM at GPT-2-small
      widths with fp32 parameters trained under amp.init("float16") with
      LAMB (lr 1e-2) and MXNet's recipe (scale_loss, backward, unscale,
      step), 10 steps on phase h's batch: the loss falls >= 0.5, every
      step launches 12 K1 + 12 K2 on route "tc" with fp16 q / k / v and
      none on another route, LayerNorm, log_softmax and the loss's mean
      return fp32; median step, tokens/s, peak memory, the loss scale's
      trajectory, one step profiled; (q2) an inf in one gradient: unscale
      False, weights and LAMB's states bitwise unchanged, the scale
      halved, the skip counted; (q3) the AMP step's unscaled gradients
      against the fp32 step's (K1 / K2 on "tf32x3") within 5e-2 of
      max|grad|, the worst parameter named; (q4) 3 steps under
      amp.init() (bf16): scale 1.0, K1 / K2 on "tc" in bf16; (q5) 5 LAMB
      steps, save_states, step 6 from a fresh Trainer with load_states
      bitwise equal to the uninterrupted step 6; (q6) every optimizer
      beyond SGD and Adam, gluon and functional, 3 updates of one block's
      parameters against a CPU copy within 1e-5 of max|w|, and its device
      ms an update; then K1 and K2 in fp16 at (8, 12, 1024, 64) beside
      SDPA fp16, their plain versions and the bound;
  (r) the imperative and Module front end: (r1)
      examples/train_mnist.py's configuration through mx.mod.Module with
      no context (gpu(0)): its mlp() (784 -> 128 -> 64 -> 10,
      SoftmaxOutput) on its synthetic set (3584 / 512), batch 128, SGD lr
      0.05 momentum 0.9, Xavier, 5 epochs, Speedometer(128, 50),
      validation accuracy >= 0.9; the same fit with shuffle off from one
      set of initial parameters on gpu(0) and on cpu(), every parameter
      within 1e-4 of max|w|; ms an epoch and samples/s (host clock); one
      fit batch profiled; (r2) ResNet-18 v1 (224^2, fp32, 1000 classes)
      exported, loaded as a Symbol with a SoftmaxOutput head and bound by
      Module for training at batch 32: one forward_backward against the
      Gluon Block under autograd.record() with SoftmaxCrossEntropyLoss
      summed (every gradient within 1e-3 of max|grad|, BatchNorm's moving
      statistics within 1e-5), then 5 Module steps beside 5 Gluon steps;
      (r3) an mx.nd battery of every op family on gpu(0) against cpu(),
      mx.nd.scaled_dot_product_attention(impl='flash') at (8, 12, 1024,
      64) bf16 under autograd.record(): exactly one K1 and one K2 launch
      on route "tc", no plain version, output and dq / dk / dv bitwise
      equal to the direct Function, the same through a Symbol bound by
      simple_bind; mx.random.seed's repeat and 9 samplers' mean and
      variance over 1e6 draws within 5 standard errors; host us a call of
      three mx.nd ops beside the torch calls; (r4) the 'local' and
      'device' kvstores: push of 4 values and pull, bitwise their sum in
      list order; set_optimizer's update bitwise the Updater's; optimizer
      states saved and loaded, bitwise. ``--module-only`` runs the build
      and phase r alone;
  (s) the word-LM slice in fp32 (TF32 off), which launches no K1-K5:
      (s1) MXNet 1.6's tied 650-d word LM (2 LSTM layers, 10,000 words,
      the decoder's weight the embedding's) trained through
      BucketingModule over buckets 10-60 at batch 32 with Adam lr 0.01 on
      word_lm.py's synthetic stream, 10 sweeps of the buckets in seeded
      orders: every bucket bound once over the default bucket's parameter
      and gradient tensors, the last sweep's perplexity at most half the
      first's; each of the first 3 steps against CPU copies given the
      card's weights and Adam states from before it, within 1e-4 of the
      max: the gradients, Adam's weights and states on the card's
      gradients, and the whole step's weights where the step's measured
      gradient difference cannot move Adam's update by the tolerance
      (the rest counted); median step ms by bucket, tokens/s, a profiled
      bucket-60 step, peak memory, us a bucket switch; (s2) the RNN op
      alone at
      (60, 32, 650), 2 layers, beside torch.nn.LSTM (cuDNN, measured only)
      on the same weights (within 1e-4 of max|out|): host ms, device ms
      as a replayed CUDA graph, launches; (s3) gluon.rnn.LSTM against the
      op on its flat parameters (1e-5), GRU / bidirectional / cells'
      unroll on the card against the CPU, 5 gluon.Trainer steps with
      clip_global_norm; (s4) sym.contrib.foreach over an LSTM step
      against the fused op, while_loop's padding, cond's branches, a
      Predictor refusing to capture _while_loop; (s5) SequentialModule +
      PythonLossModule on the card against the CPU. ``--rnn-only`` runs
      the build and phase s alone;
  (t) the SSD slice in fp32 (TF32 off), which launches no K1-K5: (t1)
      examples/ssd/train_ssd.py's configuration -- its SSD block as
      written (a user's HybridBlock: F = mx.nd on NDArrays), ImageDetIter
      over its 48 synthetic 64x64 images (JPEGs through PIL where the
      machine has it, else the same images as arrays through
      ImageDetIter.decode; a line says which), shuffle and rand_mirror,
      batch 8, Adam 0.002, 5 epochs: the last epoch's loss below the
      first's; each of the first 3 steps against a CPU copy from the
      card's weights and Adam states (loss and gradients within 1e-4,
      class targets and masks exactly, Adam on the card's gradients
      within 1e-5); host ms a step, images/s, one step profiled; the
      VOC07 mAP of MultiBoxDetection (nms_topk 50) over the set; (t2)
      SSD300-VGG16's 8732 anchors (maps 38-1, 4/6/6/6/4/4 a cell), 21
      classes, batch 32, 1-8 boxes an image: MultiBoxPrior,
      MultiBoxTarget (mining ratio 3) and MultiBoxDetection (nms_topk
      400) against their CPU runs (targets, masks, ids, scores and kept
      rows exactly; loc targets and boxes within 1e-5); the device time
      of each one's kernels (profiler), host ms and launches, and the NMS
      sweep's alone. ``--ssd-only``
      runs the build and phase t alone;
  (u) data-parallel training through kvstore='dist_sync', 2 ranks
      started by the port's launcher (mxnet_tpu_torch/kvstore/launch.py)
      on the one card over gloo, which
      launches no K1-K5: (u1) examples/distributed/cifar10_dist.py's
      configuration (synthetic CIFAR10, ToTensor, a shard a rank,
      DataLoader shuffle, batch 32 a rank, Adam 0.002, 2 epochs): every
      parameter bitwise equal across the ranks, the first step's summed
      gradients (1e-4) and Adam's weights (1e-5) against one process's
      step over both shards; (u2) resnet50_v1 fp32 at 224^2 through
      gluon.Trainer(kvstore='dist_sync'), SGD, batch 32 a rank, 3 steps:
      the ranks' trainable weights bitwise equal; step ms and the
      all-reduce's share of it for each; the liveness work's cost a call
      (check_peers, a beat, a scan). ``--dist-only`` runs the build
      and phase u alone;
  (v) the serving runtime (checks collected, the phase failing at its
      end): (v1) a Fleet of 2 thread replicas of phase d's LM (bf16, each
      bucket a CUDA graph; K1 on route "tc" at every build's warm-up runs
      and capture, none at a replay), 4 threads x 32 requests at a
      deadline: every answer within 5e-2 of max|logit| of one Predictor
      on the same weights at bucket 1 (the bitwise ones counted), 8
      coalesced requests bitwise its bucket-8 predict; requests/s, p50
      and p99 beside one BatchServer's; then replica_crash and
      replica_hang (under a 0.5 s batch watchdog) on replica 0 under the
      4 threads: every future terminates, the victim walks HEALTHY ->
      DRAINING -> DEAD -> RESTARTING -> WARMING -> HEALTHY, the failover
      time and the restart's capture seconds; (v2) one mode='process'
      replica (a 2-layer LM at phase d's widths) built on the card in a
      spawned child, its answer bitwise a Predictor's in this process,
      SIGKILLed, restarted under a new pid, answering again; (v3)
      swap_params into the captured buckets (the replay bitwise a fresh
      Predictor on the new weights, the snapshot restoring the old), then
      rollout_weights on v1's fleet: rollout_bad_weights rolled back at
      the health gate and good weights promoted, clients answered
      throughout with no error; (v4) a {fp32, int8} variant group of
      phase p's ResNet-18 (2 replicas each, K5 on route "wgmma"), each
      answer bitwise its variant's Predictor, replica_nan_storm on an
      int8 replica caught by the sentinel and retried on its sibling;
      (v5) a StreamRouter of 2 DecodeBatchers on phase n's model (bf16,
      fp32 KV, K4), decode_replica_death mid-stream: every stream
      completes, decode_reroutes, each stream's first divergence from the
      unfaulted tokens, the rerouted streams' token gap. Each line names
      the card and its power limit. ``--fleet-only`` runs the build and
      phase v alone;
  (w) resilient training (checks collected, the phase failing at its
      end), the LM of phases h / l through parallel.ShardedTrainer (bf16
      over fp32 masters, Adam, B=8, T=1024, the step fingerprint on):
      (w1) a spawned child trains 20 steps, an async CheckpointManager
      save (keep_n=2) every 5, and is SIGKILLed while its step-20 save is
      in flight; restore_latest skips the torn save and takes step 15, and
      steps 16-25 from it are bitwise an unkilled run's (losses and step
      fingerprints); the save's stall (sync, async), bytes and seconds,
      the restore's seconds; (w2) a memory cap under which B=8 raises a
      real torch.OutOfMemoryError and 2 x B=4 fits: the step retried as 2
      microbatches, sticky, bitwise an explicit microbatches=2 step; then
      the oom_step fault without the cap; (w3) the fold kernel
      (csrc/state_fold.cu) over the LM's masters and gradients against
      its plain version and fold_host, timed beside its bound; the step
      with and without the fingerprint; sdc_bitflip_param under an audit
      every 2 steps caught, rolled back and run again to the unfaulted
      params; (w4) the numerics tap every 5 steps against eager
      reductions, no capture when its cadence changes; the perf ledger's
      FLOPs, device ms and MFU; profiler.dump()'s trace naming K1 and K2;
      traceview over the step's spans; (w5) gluon.Trainer with a rollback
      HealthSentinel: nan_grad skipped and rolled back, hang_step rolled
      back by the step watchdog, an AMP fp16 loss scale through a
      checkpoint. ``--resilience-only`` runs the build, the fold's phase-b
      cases and phase w alone;
  (x) pod and peer-loss recovery: 4 gloo rank processes on the card
      train the LM (bf16 over fp32 masters, Adam, B=8 global) through
      ShardedTrainer with a pod commit every 2 steps, the fingerprint over
      the ranks (csrc/state_fold.cu's state_fold_sums, an all-reduce,
      state_fold_chain) and an audit every 2 steps; (x1) at full depth
      over {"fsdp": 2, "dp": 2} as 2 hosts, host_death kills host 1's two
      processes at step 5; (x2, 2 layers) coordinator_loss kills host 0's;
      (x3, 2 layers) peer_death kills rank 3 of a {"dp": 4} job without a
      pod and the power-of-two shrink benches rank 2. The survivors detect
      the loss, agree on it, shrink, rebuild their process groups, restore
      the last commit and go on; their losses, fingerprints and final
      parameters must equal a fresh job on the shrunk axes that restores
      the same checkpoint (the oracle), bitwise. x1 also holds the sums and
      chain kernels to sums_plain / chain_plain and the fold over the ranks
      to one-rank state_fold of the gathered state, and times the sums
      launch beside its bound. ``--pod-only`` runs the build, the fold's
      phase-b cases and phase x alone.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. ``--summary PATH`` also writes the
measurements as JSON. Without CUDA the script exits 1 and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
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
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FMA_FLOPS = 67e12   # f32 on the CUDA cores
PEAK_BYTES = 3.35e12
PEAK_INT8_OPS = 1979e12       # int8 on the tensor cores

# GPT-2-small widths: the slice's model
VOCAB, UNITS, HEADS, LAYERS, T = 50257, 768, 12, 12, 1024
BATCH = 8

# ResNet-50 v1's 3x3 convs (stride 1, SAME, Cin = Cout): (H = W, C)
RESNET_3X3 = ((56, 64), (28, 128), (14, 256), (7, 512))
CONV_N = 32
# K3's 16-bit sum and sumsq, max|a - b| / max|ref|: the sound kernel reads
# at most ~1e-5 at these shapes (f32 sums in other orders), statistics
# taken from the rounded y read ~1e-4 (fp16) to ~1e-3 (bf16) on sum.
CONV_STATS_TOL_16 = 5e-5
# K3's 3xTF32 route (fp32): y, sum and sumsq, max|a - b| / max|ref| against
# the plain version (TF32 off). The CPU emulation of its products reads at
# most ~1e-6 against mxnet_tpu's Pallas K3 (tests/test_torch_conv_tf32x3.py),
# one TF32 pass 1.4e-4-3.3e-4: the one-pass control below must miss it.
CONV_TF32X3_TOL = 1e-5


def log(*args):
    print(*args, flush=True)


def card_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def ptxas_usage(build_log):
    """[(kernel, 'Used N registers, ...; N bytes spill stores, ...')] from
    nvcc's -Xptxas -v output, kernel names demangled with c++filt where it
    exists."""
    entries, usages, spills = [], [], []
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entries.append(m.group(1))
        elif "spill stores" in line and len(spills) < len(entries):
            spills.append(line.strip())
        elif "Used" in line and len(usages) < len(entries):
            usages.append(line.split(":", 1)[-1].strip())
    usages = [f"{u}; {sp}" for u, sp in zip(usages, spills)] + usages[
        len(spills):]
    try:
        names = subprocess.run(["c++filt"], input="\n".join(entries),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = entries
    names = [re.sub(r"\(.*", "", n.replace("(anonymous namespace)::", "")
                    .replace("void ", "")) for n in names]
    return list(zip(names, usages))


def ptxas_advisories(build_log):
    """ptxas's performance advisories in nvcc's output (e.g. wgmma
    instructions serialized), one line each."""
    return [line.strip() for line in build_log.splitlines()
            if "Performance" in line or "serializ" in line]


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
def flash_inputs(torch, gen, shape, dtype, layout):
    """Seeded q, k, v (B, H, T, D) ~ N(0, 1). ``layout="qkv"`` gives them as
    the LM's strided views of one (B, T, 3 * H * D) buffer (the qkv
    projection's output); ``"contiguous"`` as three contiguous tensors;
    ``"misaligned"`` as contiguous tensors whose base is one element past
    a 16-byte boundary."""
    b, h, t, d = shape
    if layout == "qkv":
        buf = torch.randn((b, t, 3 * h * d), generator=gen,
                          device="cuda").to(dtype)
        x = buf.reshape(b, t, 3 * h, d).transpose(1, 2)
        return x[:, :h], x[:, h:2 * h], x[:, 2 * h:]
    if layout == "misaligned":
        # contiguous, but one element past a 16-byte boundary
        n = b * h * t * d
        return [torch.randn(n + 1, generator=gen, device="cuda").to(dtype)[
            1:].view(shape) for _ in range(3)]
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(3)]


def check_flash(torch, kernels):
    """K1 against its plain version on fixed cases, on its three routes:
    the CUDA-core kernel (D=80, D=256, misaligned bases), the 3xTF32
    kernel (fp32, D of 64 and 128, contiguous or the LM's strided layout)
    and the tensor-core kernel (bf16 and fp16, the same layouts). Returns
    the check records and the largest O error at the slice's shape, bf16
    and fp32."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    tol32 = (1e-4, 1e-4, "fp32: O and lse within 1e-4 (f32 sums in other "
             "orders; the tf32x3 kernel's products as 3xTF32, ~2^-22 of "
             "each product)")
    tol16 = (4.0, 1e-3, "16-bit: O within 4 output ulps (O rounded once "
             "from f32 sums taken in another order; the tensor-core kernel "
             "feeds P to P.V as hi + lo 16-bit terms, the CUDA-core one in "
             "f32; below max|O| * 2^-6 the ulp of that floor), lse within "
             "1e-3 (f32)")
    sl = (BATCH, HEADS, T, UNITS // HEADS)
    cases = [
        # name, (B, H, T, D), dtype, causal, q_offset, k_offset, layout,
        # route
        ("fp32 causal", (2, 4, 256, 64), f32, True, 0, 0, "contiguous",
         "tf32x3"),
        ("fp32 non-causal", (2, 4, 256, 64), f32, False, 0, 0,
         "contiguous", "tf32x3"),
        ("fp32 causal D=128", (1, 2, 512, 128), f32, True, 0, 0,
         "contiguous", "tf32x3"),
        ("fp32 causal ragged T=1000", (2, 2, 1000, 64), f32, True, 0, 0,
         "contiguous", "tf32x3"),
        ("fp32 non-causal ragged T=1000", (1, 2, 1000, 64), f32, False, 0,
         0, "contiguous", "tf32x3"),
        ("fp32 causal q_offset=128", (1, 2, 256, 64), f32, True, 128, 0,
         "contiguous", "tf32x3"),
        ("fp32 causal whole-skip k_offset=128", (1, 2, 256, 64), f32, True,
         0, 128, "contiguous", "tf32x3"),
        ("fp32 causal whole-skip k_offset=128 D=128", (1, 2, 256, 128), f32,
         True, 0, 128, "contiguous", "tf32x3"),
        ("fp32 causal qkv views", (2, 4, 256, 64), f32, True, 0, 0, "qkv",
         "tf32x3"),
        ("fp32 causal D=128 qkv views ragged T=300", (2, 2, 300, 128), f32,
         True, 0, 0, "qkv", "tf32x3"),
        ("fp32 causal slice shape, qkv views", sl, f32, True, 0, 0, "qkv",
         "tf32x3"),
        ("fp32 causal D=80 (masked in D=128)", (1, 2, 300, 80), f32, True,
         0, 0, "contiguous", "simt"),
        ("fp32 causal D=256", (1, 2, 256, 256), f32, True, 0, 0,
         "contiguous", "simt"),
        ("fp32 causal misaligned base", (2, 4, 256, 64), f32, True, 0, 0,
         "misaligned", "simt"),
        ("bf16 causal D=256", (1, 2, 256, 256), bf16, True, 0, 0,
         "contiguous", "simt"),
        ("bf16 causal D=80", (1, 2, 300, 80), bf16, True, 0, 0,
         "contiguous", "simt"),
        ("bf16 causal slice shape", sl, bf16, True, 0, 0, "contiguous",
         "tc"),
        ("fp16 causal slice shape", sl, f16, True, 0, 0, "contiguous",
         "tc"),
        ("bf16 causal slice shape, qkv views", sl, bf16, True, 0, 0, "qkv",
         "tc"),
        ("bf16 causal D=128", (2, 4, 512, 128), bf16, True, 0, 0,
         "contiguous", "tc"),
        ("fp16 causal D=128 qkv views", (2, 4, 512, 128), f16, True, 0, 0,
         "qkv", "tc"),
        ("bf16 non-causal", (2, 4, 256, 64), bf16, False, 0, 0,
         "contiguous", "tc"),
        ("fp16 non-causal D=128", (1, 4, 384, 128), f16, False, 0, 0,
         "contiguous", "tc"),
        ("bf16 causal ragged T=1000", (2, 2, 1000, 64), bf16, True, 0, 0,
         "contiguous", "tc"),
        ("bf16 non-causal ragged T=1000", (1, 2, 1000, 64), bf16, False, 0,
         0, "contiguous", "tc"),
        ("bf16 causal ragged T=1000 D=128", (1, 2, 1000, 128), bf16, True,
         0, 0, "qkv", "tc"),
        ("bf16 causal short T=40", (2, 3, 40, 64), bf16, True, 0, 0, "qkv",
         "tc"),
        ("bf16 causal q_offset=128", (1, 2, 256, 64), bf16, True, 128, 0,
         "contiguous", "tc"),
        ("bf16 causal whole-skip k_offset=128", (1, 2, 256, 64), bf16, True,
         0, 128, "contiguous", "tc"),
        ("fp16 causal whole-skip k_offset=128 D=128", (1, 2, 256, 128), f16,
         True, 0, 128, "contiguous", "tc"),
    ]
    log(f"[b] K1 tolerances -- {tol32[2]}; {tol16[2]}")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    records, slice_err, slice_err32 = [], 0.0, 0.0
    for name, shape, dtype, causal, qo, ko, layout, route in cases:
        q, k, v = flash_inputs(torch, gen, shape, dtype, layout)
        kw = dict(causal=causal, return_lse=True, q_offset=qo, k_offset=ko)
        before = dict(kernels.flash_attention.launches_by_route)
        out, lse = kernels.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        took = [r for r, n in kernels.flash_attention.launches_by_route
                .items() if n != before[r]]
        ref, ref_lse = kernels.flash_attention_reference(q, k, v, **kw)
        l_err = (lse - ref_lse).abs().max().item()
        if dtype == f32:
            o_err = (out.float() - ref.float()).abs().max().item()
            unit = ""
        else:
            o_err, unit = ulp_err(torch, out, ref), " ulp"
        o_tol, l_tol, _ = tol32 if dtype == f32 else tol16
        ok = (took == [route] and out.shape == ref.shape
              and lse.shape == ref_lse.shape and math.isfinite(o_err)
              and o_err <= o_tol and l_err <= l_tol)
        extra = ""
        if ko > qo:
            # rows before k_offset - q_offset see no key: O = 0 and
            # lse = -1e30 + log(1e-20), exactly
            blind = ko - qo
            want = torch.tensor(-1e30, dtype=torch.float32) + math.log(1e-20)
            exact = bool((out[:, :, :blind] == 0).all()) and bool(
                (lse[:, :, :blind].cpu() == want).all())
            ok = ok and exact
            extra += f"; blind rows exact: {exact}"
        if route in ("tc", "tf32x3"):
            again = kernels.flash_attention(q, k, v, **kw)
            same = all(torch.equal(a, b) for a, b in zip((out, lse), again))
            extra += f"; second launch bitwise equal: {same}"
            ok = ok and same
            if layout == "qkv":
                packed = kernels.flash_attention(
                    q.contiguous(), k.contiguous(), v.contiguous(), **kw)
                same = all(torch.equal(a, b)
                           for a, b in zip((out, lse), packed))
                extra += f"; == contiguous copies bitwise: {same}"
                ok = ok and same
        log(f"[b] {name:42s} {str(tuple(shape)):20s} {'/'.join(took):4s} "
            f"O err {o_err:.3e}{unit} (tol {o_tol:g})  lse err {l_err:.3e} "
            f"(tol {l_tol:g}){extra}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase b: flash_attention disagrees with its "
                             f"plain version on '{name}' (route {took}, "
                             f"want {route})")
        if shape == sl and dtype == bf16:
            slice_err = max(slice_err,
                            (out.float() - ref.float()).abs().max().item())
        if shape == sl and dtype == f32:
            slice_err32 = max(slice_err32, o_err)
        records.append({"case": name, "route": route, "o_err": o_err,
                        "o_err_unit": unit.strip() or "abs",
                        "lse_err": l_err})
    return records, slice_err, slice_err32


def bwd_inputs(torch, kernels, gen, shape, dtype, layout, causal, qo, ko,
               with_dlse):
    """q, k, v as flash_inputs gives them; O and lse from K1 on the card; a
    seeded dO ~ N(0, 1) (``layout="qkv"``: the (B, H, T, D) view of
    (B, T, H, D) memory, as autograd hands the LM's K1 output its
    cotangent) and, with ``with_dlse``, a seeded dlse ~ N(0, 1)."""
    b, h, t, d = shape
    q, k, v = flash_inputs(torch, gen, shape, dtype, layout)
    out, lse = kernels.flash_attention(q, k, v, causal=causal,
                                       return_lse=True, q_offset=qo,
                                       k_offset=ko)
    if layout == "qkv":
        dout = torch.randn((b, t, h, d), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
    else:
        dout = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    dlse = (torch.randn((b, h, t, 1), generator=gen, device="cuda")
            if with_dlse else None)
    return q, k, v, out, lse, dout, dlse


def grads_err(torch, got, ref):
    """Largest error of dq, dk, dv: output ulps (ulp_err) for 16-bit,
    max|a - b| / max|b| for fp32."""
    if ref[0].dtype == torch.float32:
        return max(rel_err(a, b) for a, b in zip(got, ref))
    return max(ulp_err(torch, a, b) for a, b in zip(got, ref))


def check_flash_bwd(torch, kernels):
    """K2 (the flash-attention backward) against its plain version on fixed
    cases, on its three routes (fp32 as 3xTF32 "tf32x3", 16-bit "tc", and
    the CUDA cores "simt" for D 80 and 256 and misaligned bases): causal
    and not; D 64, 128, 80 (in the 128-wide instantiation) and 256; T
    1024, ragged 1000 and 300; q and k offsets, rows that see no key; a
    nonzero dlse; the LM's strided q/k/v with the tensor-core K1's O and a
    strided dO. A second launch must be bitwise equal, and a plain version
    without the dlse term must fail the same check. Then the K1 + K2
    autograd Function against autograd through dense attention. Returns
    the check records and the largest error at the slice's shape, bf16
    and fp32."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    tol32 = 1e-4
    tol16 = 4.0
    why = (f"fp32: dq, dk, dv within {tol32:g} of max|ref| (f32 sums in "
           f"other orders); 16-bit: within {tol16:g} output ulps (one "
           "rounding of f32 sums taken in another order; below max|ref| * "
           "2^-6 the ulp of that floor)")
    sl = (BATCH, HEADS, T, UNITS // HEADS)
    cases = [
        # name, (B, H, T, D), dtype, causal, q_offset, k_offset, layout,
        # dlse, route
        ("fp32 causal", (2, 4, 256, 64), f32, True, 0, 0, "contiguous",
         False, "tf32x3"),
        ("fp32 non-causal", (2, 4, 256, 64), f32, False, 0, 0,
         "contiguous", False, "tf32x3"),
        ("fp32 causal D=128", (1, 2, 512, 128), f32, True, 0, 0,
         "contiguous", False, "tf32x3"),
        ("fp32 causal slice shape, LM layout", sl, f32, True, 0, 0, "qkv",
         False, "tf32x3"),
        ("fp32 causal D=128 LM layout ragged T=300", (2, 2, 300, 128), f32,
         True, 0, 0, "qkv", False, "tf32x3"),
        ("fp32 causal q_offset=128", (1, 2, 256, 64), f32, True, 128, 0,
         "contiguous", False, "tf32x3"),
        ("fp32 causal k_offset=100 (blind rows)", (1, 2, 256, 64), f32,
         True, 0, 100, "contiguous", False, "tf32x3"),
        ("fp32 causal k_offset=100 (blind rows) D=128", (1, 2, 256, 128),
         f32, True, 0, 100, "contiguous", False, "tf32x3"),
        ("fp32 causal dlse", (2, 4, 256, 64), f32, True, 0, 0, "contiguous",
         True, "tf32x3"),
        ("fp32 non-causal ragged T=1000 dlse", (1, 2, 1000, 64), f32, False,
         0, 0, "contiguous", True, "tf32x3"),
        ("fp32 causal dlse LM layout", (2, 4, 256, 64), f32, True, 0, 0,
         "qkv", True, "tf32x3"),
        ("fp32 causal ragged T=300 D=80", (1, 2, 300, 80), f32, True, 0, 0,
         "contiguous", False, "simt"),
        ("fp32 causal D=256", (1, 2, 256, 256), f32, True, 0, 0,
         "contiguous", False, "simt"),
        ("fp32 causal misaligned base dlse", (2, 4, 256, 64), f32, True, 0,
         0, "misaligned", True, "simt"),
        ("bf16 causal D=80 ragged T=300", (1, 2, 300, 80), bf16, True, 0, 0,
         "contiguous", False, "simt"),
        ("fp16 causal D=256", (1, 2, 256, 256), f16, True, 0, 0,
         "contiguous", False, "simt"),
        ("bf16 causal D=80 dlse", (1, 2, 256, 80), bf16, True, 0, 0,
         "contiguous", True, "simt"),
        ("bf16 causal slice shape", sl, bf16, True, 0, 0, "contiguous",
         False, "tc"),
        ("fp16 causal slice shape", sl, f16, True, 0, 0, "contiguous",
         False, "tc"),
        ("bf16 causal slice shape, LM layout", sl, bf16, True, 0, 0, "qkv",
         False, "tc"),
        ("bf16 non-causal", (2, 4, 256, 64), bf16, False, 0, 0,
         "contiguous", False, "tc"),
        ("bf16 causal D=128 T=1024", (1, 4, 1024, 128), bf16, True, 0, 0,
         "contiguous", False, "tc"),
        ("fp16 causal D=128 LM layout", (2, 4, 512, 128), f16, True, 0, 0,
         "qkv", False, "tc"),
        ("fp16 non-causal D=128 ragged T=300", (1, 2, 300, 128), f16, False,
         0, 0, "contiguous", False, "tc"),
        ("fp16 causal ragged T=1000", (2, 2, 1000, 64), f16, True, 0, 0,
         "contiguous", False, "tc"),
        ("bf16 causal ragged T=40", (2, 3, 40, 64), bf16, True, 0, 0, "qkv",
         False, "tc"),
        ("bf16 causal q_offset=128", (1, 2, 256, 64), bf16, True, 128, 0,
         "contiguous", False, "tc"),
        ("bf16 causal k_offset=100 (blind rows)", (1, 2, 256, 64), bf16,
         True, 0, 100, "contiguous", False, "tc"),
        ("fp16 causal k_offset=100 (blind rows) D=128", (1, 2, 256, 128),
         f16, True, 0, 100, "contiguous", False, "tc"),
        ("bf16 causal dlse", (2, 4, 256, 64), bf16, True, 0, 0, "contiguous",
         True, "tc"),
        ("fp16 causal dlse LM layout", (2, 4, 256, 64), f16, True, 0, 0,
         "qkv", True, "tc"),
    ]
    log(f"[b] K2 tolerances -- {why}")
    gen = torch.Generator(device="cuda").manual_seed(2024)
    records, slice_err, slice_err32, relaunched = [], 0.0, 0.0, set()
    for name, shape, dtype, causal, qo, ko, layout, with_dlse, route in \
            cases:
        q, k, v, out, lse, dout, dlse = bwd_inputs(
            torch, kernels, gen, shape, dtype, layout, causal, qo, ko,
            with_dlse)
        kw = dict(causal=causal, dlse=dlse, q_offset=qo, k_offset=ko)
        before = dict(kernels.flash_attention_backward.launches_by_route)
        got = kernels.flash_attention_backward(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        took = [r for r, n in kernels.flash_attention_backward
                .launches_by_route.items() if n != before[r]]
        ref = kernels.flash_attention_backward_reference(
            q, k, v, out, lse, dout, **kw)
        err = grads_err(torch, got, ref)
        tol = tol32 if dtype == f32 else tol16
        ok = (took == [route] and all(
            a.shape == b.shape and a.dtype == dtype
            and bool(torch.isfinite(a.float()).all())
            for a, b in zip(got, ref)) and err <= tol)
        extra = ""
        if ko > qo:
            # rows before k_offset - q_offset see no key: dq exactly 0 there,
            # and zeroing their dO leaves dk and dv bitwise unchanged
            blind = ko - qo
            dout2 = dout.clone()
            dout2[:, :, :blind] = 0
            again = kernels.flash_attention_backward(q, k, v, out, lse, dout2,
                                                     **kw)
            exact = (bool((got[0][:, :, :blind] == 0).all())
                     and torch.equal(got[1], again[1])
                     and torch.equal(got[2], again[2]))
            extra += f"; blind rows: dq 0, add nothing to dk/dv: {exact}"
            ok = ok and exact
        if (dtype, route) not in relaunched:
            relaunched.add((dtype, route))
            same = all(torch.equal(a, b) for a, b in zip(
                got, kernels.flash_attention_backward(q, k, v, out, lse, dout,
                                                      **kw)))
            extra += f"; second launch bitwise equal: {same}"
            ok = ok and same
        if with_dlse:
            # the check has teeth: the plain version without the dlse term
            wrong = kernels.flash_attention_backward_reference(
                q, k, v, out, lse, dout, causal=causal, q_offset=qo,
                k_offset=ko)
            wrong_err = grads_err(torch, wrong, ref)
            caught = wrong_err > tol
            extra += (f"; without the dlse term {wrong_err:.3e}: caught "
                      f"{caught}")
            ok = ok and caught
        if dtype != f32 and shape == sl and layout == "contiguous":
            # informational: p rounded to the input dtype before p^T dO
            p16 = p_rounded_dv(torch, q, k, out, lse, dout, causal)
            extra += (f"; p rounded to {str(dtype)[6:]} before p^T dO: dv "
                      f"{ulp_err(torch, p16, ref[2]):.2f} ulp")
        unit = "" if dtype == f32 else " ulp"
        log(f"[b] bwd {name:42s} {str(tuple(shape)):20s} "
            f"{'/'.join(took):4s} err {err:.3e}{unit} (tol {tol:g}){extra}  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase b: flash_attention_backward disagrees "
                             f"with its plain version on '{name}' (route "
                             f"{took}, want {route})")
        if shape == sl:
            worst = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(got, ref))
            if dtype == bf16:
                slice_err = max(slice_err, worst)
            elif dtype == f32:
                slice_err32 = max(slice_err32, worst)
        records.append({"case": name, "route": route, "err": err,
                        "err_unit": unit.strip() or "rel"})
    records += check_bwd_into_heads(torch, kernels, gen)
    records.append(check_tf32x3_grid_edge(torch, kernels))
    records.append(check_flash_function(torch, kernels, gen))
    records.append(check_flash_qkv(torch, kernels, gen))
    return records, slice_err, slice_err32


SENTINEL = -7.25


def check_bwd_into_heads(torch, kernels, gen):
    """Each tensor-core K2 (bf16 "tc", fp32 "tf32x3") writing dq, dk, dv
    through their strides into three head ranges of one (B, T, 4H, D)
    buffer prefilled with a sentinel: the written heads equal, bitwise,
    the same launch into contiguous gradients, and every element of the
    fourth head range keeps the sentinel."""
    b, h, t, d = 2, 4, 300, 64
    records = []
    for dtype, route in ((torch.bfloat16, "tc"), (torch.float32, "tf32x3")):
        q, k, v, out, lse, dout, _ = bwd_inputs(
            torch, kernels, gen, (b, h, t, d), dtype, "qkv", True, 0, 0,
            False)
        want = kernels.flash_attention_backward(q, k, v, out, lse, dout,
                                                causal=True)
        big = torch.full((b, t, 4 * h, d), SENTINEL, dtype=dtype,
                         device="cuda")
        heads = big.transpose(1, 2)
        grads = (heads[:, 3 * h:], heads[:, :h], heads[:, 2 * h:3 * h])
        before = kernels.flash_attention_backward.launches_by_route[route]
        kernels.flash_attention_backward(q, k, v, out, lse, dout,
                                         causal=True, grads=grads)
        torch.cuda.synchronize()
        launched = (kernels.flash_attention_backward.launches_by_route[route]
                    - before)
        same = all(torch.equal(g, w) for g, w in zip(grads, want))
        kept = bool((heads[:, h:2 * h] == SENTINEL).all())
        ok = launched == 1 and same and kept
        log(f"[b] bwd into the heads of a (B, T, 4H, D) buffer "
            f"{(b, h, t, d)} {str(dtype)[6:]} ({route}): == contiguous "
            f"gradients bitwise: {same}; the other heads keep the sentinel: "
            f"{kept}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("phase b: K2 writing through output strides "
                             "disagrees or writes outside its heads")
        records.append({"case": f"bwd into strided heads {route}",
                        "bitwise": same, "sentinel_kept": kept})
    return records


def check_tf32x3_grid_edge(torch, kernels):
    """K1 and K2 on fp32 D=128 at the "tf32x3" route's largest T
    (kernels._TF32_MAX_T = 65535 * 64: 65535 tiles of 64 rows in each
    grid): one seeded (1, 1, T, 128) tensor as q, k, v and dO, causal with
    k_offset = T - 64, so that only the last 64 rows see a key (keys 0-63).
    Those rows' O, lse and dq, and those keys' dk and dv, hold the plain
    version on the 64 x 64 slice within 1e-4 (of max|ref| for the
    gradients); every other row of O, dq, dk and dv is exactly 0, and
    every other lse is the plain version's no-key value."""
    t, d, tol = kernels._TF32_MAX_T, 128, 1e-4
    gen = torch.Generator(device="cuda").manual_seed(65535)
    x = torch.randn((1, 1, t, d), generator=gen, device="cuda")
    kw = dict(causal=True, k_offset=t - 64)
    counts = (kernels.flash_attention.launches_by_route,
              kernels.flash_attention_backward.launches_by_route)
    before = [c["tf32x3"] for c in counts]
    out, lse = kernels.flash_attention(x, x, x, return_lse=True, **kw)
    dq, dk, dv = kernels.flash_attention_backward(x, x, x, out, lse, x, **kw)
    torch.cuda.synchronize()
    launched = [c["tf32x3"] - n for c, n in zip(counts, before)]
    q, kv = x[:, :, -64:], x[:, :, :64]
    ref, ref_lse = kernels.flash_attention_reference(q, kv, kv, causal=True,
                                                     return_lse=True)
    ref_g = kernels.flash_attention_backward_reference(
        q, kv, kv, out[:, :, -64:], lse[:, :, -64:], q, causal=True)
    blind_lse = kernels.flash_attention_reference(
        kv[:, :, :1], kv[:, :, :1], kv[:, :, :1], causal=True,
        return_lse=True, k_offset=1)[1]
    err = max((out[:, :, -64:] - ref).abs().max().item(),
              (lse[:, :, -64:] - ref_lse).abs().max().item())
    g_err = max(rel_err(dq[:, :, -64:], ref_g[0]),
                rel_err(dk[:, :, :64], ref_g[1]),
                rel_err(dv[:, :, :64], ref_g[2]))
    zero = (bool((out[:, :, :-64] == 0).all())
            and bool((dq[:, :, :-64] == 0).all())
            and bool((dk[:, :, 64:] == 0).all())
            and bool((dv[:, :, 64:] == 0).all())
            and bool((lse[:, :, :-64] == blind_lse).all()))
    ok = launched == [1, 1] and err <= tol and g_err <= tol and zero
    log(f"[b] tf32x3 at the grid edge (1, 1, {t}, {d}), only the last 64 "
        f"rows see keys: tf32x3 launches K1/K2 {launched}; O, lse err "
        f"{err:.3e}, grads err {g_err:.3e} of max|ref| (tol {tol:g}); every "
        f"other row 0 and no-key lse: {zero}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase b: the tf32x3 kernels fail at the largest T "
                         "their route takes")
    del x, out, lse, dq, dk, dv
    torch.cuda.empty_cache()
    return {"case": f"tf32x3 grid edge T={t} D={d}", "err": err,
            "grads_err": g_err, "zero_elsewhere": zero}


def check_flash_qkv(torch, kernels, gen):
    """flash_attention_qkv (the LM's path: K1 on the qkv buffer's head
    views, K2 writing one d(qkv) buffer) against autograd through dense
    attention in f32 on the same values -- fp32 within 1e-4 of max|grad|,
    bf16 within 3e-2 (as check_flash_function) -- and its d(qkv) bitwise
    equal to the one autograd scatters back from the three-view Function
    on the same card."""
    b, h, t, d = 2, 4, 256, 64

    def split(buf):
        x = buf.reshape(b, t, 3 * h, d).transpose(1, 2)
        return x[:, :h], x[:, h:2 * h], x[:, 2 * h:]

    def dense(q, k, v):
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        logits = logits.masked_fill(torch.ones(
            t, t, dtype=torch.bool, device=q.device).triu(1), float("-inf"))
        return torch.matmul(torch.softmax(logits, -1), v)

    errs = {}
    for dtype, tol, route in ((torch.float32, 1e-4, "tf32x3"),
                              (torch.bfloat16, 3e-2, "tc")):
        x = torch.randn((b, t, 3 * h * d), generator=gen,
                        device="cuda").to(dtype)
        wo = torch.randn((b, h, t, d), generator=gen, device="cuda")
        packed = x.clone().requires_grad_(True)
        before = dict(kernels.flash_attention_backward.launches_by_route)
        (kernels.flash_attention_qkv(packed, h, causal=True).float()
         * wo).sum().backward()
        took = {r: n - before[r] for r, n in
                kernels.flash_attention_backward.launches_by_route.items()}
        views = x.clone().requires_grad_(True)
        (kernels.flash_attention_with_grad(*split(views), causal=True)
         .float() * wo).sum().backward()
        ref = x.float().requires_grad_(True)
        (dense(*split(ref)) * wo).sum().backward()
        err = rel_err(packed.grad, ref.grad)
        same = torch.equal(packed.grad, views.grad)
        ok = (took[route] == 1 and sum(took.values()) == 1 and same
              and err <= tol and packed.grad.dtype == dtype)
        log(f"[b] packed qkv Function {str(dtype)[6:]} {(b, h, t, d)} "
            f"causal ({route}): d(qkv) vs dense autograd (f32) {err:.3e} of "
            f"max|grad| (tol {tol:g}); == three-view Function's d(qkv) "
            f"bitwise: {same}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("phase b: the packed qkv Function's gradient "
                             "disagrees")
        errs[str(dtype)[6:]] = err
    return {"case": "packed qkv Function", "rel_errs": errs}


def p_rounded_dv(torch, q, k, out, lse, dout, causal):
    """dv of the plain version with p rounded to the input dtype before
    p^T dO: a wrong variant, logged beside the 16-bit tolerance."""
    t, d = q.shape[-2:]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    if causal:
        logits = logits.masked_fill(torch.ones(
            t, t, dtype=torch.bool, device=q.device).triu(1), float("-inf"))
    p = torch.exp(logits - lse).to(q.dtype).float()
    return torch.matmul(p.transpose(-1, -2), dout.float()).to(q.dtype)


def check_flash_function(torch, kernels, gen):
    """flash_attention_with_lse (K1 forward, K2 backward through
    torch.autograd) against autograd through dense attention in f32, on a
    loss that uses both O and lse, with q, k, v the LM's views of one
    (B, T, 3 H D) leaf: fp32 (3xTF32 K1 and K2) within 1e-4 of max|grad|,
    bf16 (tensor-core K1) within 3e-2 of max|grad| of the f32 dense
    gradient of the same bf16 values (O and the gradients are rounded to
    bf16, 2^-8, and delta is formed from the rounded O)."""
    b, h, t, d = 2, 4, 256, 64

    def split(buf):
        x = buf.reshape(b, t, 3 * h, d).transpose(1, 2)
        return x[:, :h], x[:, h:2 * h], x[:, 2 * h:]

    def dense(q, k, v):
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        logits = logits.masked_fill(torch.ones(
            t, t, dtype=torch.bool, device=q.device).triu(1), float("-inf"))
        return torch.matmul(torch.softmax(logits, -1), v), \
            torch.logsumexp(logits, -1, keepdim=True)

    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        buf = torch.randn((b, t, 3 * h * d), generator=gen,
                          device="cuda").to(dtype).requires_grad_(True)
        wo = torch.randn((b, h, t, d), generator=gen, device="cuda")
        wl = torch.randn((b, h, t, 1), generator=gen, device="cuda")
        before = kernels.flash_attention_backward.launches
        o, lse = kernels.flash_attention_with_lse(*split(buf), causal=True)
        ((o.float() * wo).sum() + (lse * wl).sum()).backward()
        launched = kernels.flash_attention_backward.launches - before
        ref = buf.detach().float().requires_grad_(True)
        o_r, lse_r = dense(*split(ref))
        ((o_r * wo).sum() + (lse_r * wl).sum()).backward()
        err = rel_err(buf.grad, ref.grad)
        ok = launched == 1 and err <= tol and buf.grad.dtype == dtype
        log(f"[b] K1 + K2 autograd Function {str(dtype)[6:]} LM layout "
            f"{(b, h, t, d)} causal, loss on O and lse: d(qkv) vs dense "
            f"autograd (f32) {err:.3e} of max|grad| (tol {tol:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("phase b: the flash autograd Function's "
                             "gradients disagree with dense attention")
        errs[str(dtype)[6:]] = err
    return {"case": "K1 + K2 autograd Function", "rel_errs": errs}


def ulp_err(torch, got, ref):
    """Largest |got - ref| in units in the last place of ``ref``'s 16-bit
    dtype. Values below 2^-6 of max|ref| take the ulp of that floor: there
    the two f32 accumulators, summed in other orders, differ by more than
    an ulp of the tiny value but far less than one of the floor."""
    mant, min_exp = {torch.bfloat16: (7, -126), torch.float16: (10, -14)}[
        ref.dtype]
    r = ref.float().abs()
    mag = torch.maximum(r, r.max() * 2.0 ** -6).clamp_min(
        torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)).clamp_min(min_exp) - mant)
    return ((got.float() - ref.float()).abs() / ulp).max().item()


def rel_err(a, b):
    """max|a - b| / max|b| (0 when both are all zero)."""
    scale = b.float().abs().max().item()
    err = (a.float() - b.float()).abs().max().item()
    return err / scale if scale else err


def conv_inputs(torch, gen, n, h, w, cin, cout, dtype, misaligned=False):
    """Seeded x (N, H, W, Cin) ~ N(0, 1) and w (3, 3, Cin, Cout) scaled by
    1/sqrt(9 Cin), so y ~ N(0, 1). ``misaligned``: x contiguous, but one
    element past a 16-byte boundary."""
    x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(dtype)
    wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
          / math.sqrt(9 * cin)).to(dtype)
    if misaligned:
        x = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")[1:].view(
            x.shape).copy_(x)
    return x, wt


def one_tf32_pass(torch, kernels, x, w):
    """The plain version on the TF32 hi parts of x and w: K3 with every
    product taken in one TF32 pass (hi x hi is exact in f32), the control
    that the 3xTF32 tolerance must reject."""
    return kernels.conv3x3_bn_stats_reference(
        kernels.tf32_split_reference(x)[0], kernels.tf32_split_reference(w)[0])


def check_conv(torch, kernels):
    """K3 against its plain version on fixed cases, on its three routes:
    the CUDA-core kernel (ragged channels, a misaligned base), the
    tensor-core kernel (bf16 and fp16, channels in multiples of 64:
    ResNet-50's shapes, a ragged last tile, H != W, N = 1, Cin != Cout) and
    the 3xTF32 one (fp32: ResNet-50's shapes and the same edges, Cin = 32;
    its one tiling, 64 x 64), every tile rule of the 16-bit kernel forced
    on one shape, a second launch bitwise equal for each route and tile
    rule, the 3xTF32
    weight pre-pass bitwise against its plain version, and the trainable
    wrapper's gradients. The 16-bit statistics limit is shown to catch
    statistics taken from the rounded y: that control (the sum of
    y.float()) must exceed it on every bf16 tensor-core case. The 3xTF32
    limit is shown to catch one TF32 pass: that control (the plain version
    on the TF32 hi parts) must exceed it on every fp32 ResNet case. Returns
    the check records."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = [("fp32 ragged", (3, 7, 7, 5, 13), f32, "simt"),
             ("fp32 non-square Cout 32", (2, 9, 11, 64, 32), f32, "simt"),
             ("fp32 misaligned x", (2, 9, 11, 64, 64), f32, "simt"),
             ("bf16 ragged channels", (3, 7, 7, 5, 13), bf16, "simt"),
             ("fp16 Cout 96", (2, 9, 11, 64, 96), f16, "simt")]
    cases += [(f"fp32 resnet {hw}x{hw}x{c}", (CONV_N, hw, hw, c, c), f32,
               "tf32x3") for hw, c in RESNET_3X3]
    cases += [("fp32 M not a multiple of BM", (3, 7, 7, 64, 64), f32,
               "tf32x3"),
              ("fp32 H != W", (2, 9, 11, 64, 128), f32, "tf32x3"),
              ("fp32 N=1 56x56x64", (1, 56, 56, 64, 64), f32, "tf32x3"),
              ("fp32 Cin 512 Cout 64", (8, 14, 14, 512, 64), f32, "tf32x3"),
              ("fp32 Cin 64 Cout 512", (8, 14, 14, 64, 512), f32, "tf32x3"),
              ("fp32 Cin 32", (4, 14, 14, 32, 64), f32, "tf32x3")]
    cases += [(f"{name} resnet {hw}x{hw}x{c}", (CONV_N, hw, hw, c, c), dt,
               "tc")
              for name, dt in (("bf16", bf16), ("fp16", f16))
              for hw, c in RESNET_3X3]
    cases += [("bf16 M not a multiple of BM", (3, 7, 7, 64, 64), bf16, "tc"),
              ("fp16 H != W", (2, 9, 11, 64, 128), f16, "tc"),
              ("bf16 N=1 56x56x64", (1, 56, 56, 64, 64), bf16, "tc"),
              ("bf16 Cin 512 Cout 64", (8, 14, 14, 512, 64), bf16, "tc"),
              ("bf16 Cin 64 Cout 512", (8, 14, 14, 64, 512), bf16, "tc")]
    forced = (2, 9, 11, 128, 128)
    cases += [(f"bf16 forced tiles {t}", forced, bf16, t)
              for t in ((128, 128), (128, 64), (64, 128), (64, 64))]
    gen = torch.Generator(device="cuda").manual_seed(4321)
    sms = kernels._sm_count(torch.cuda.current_device())
    records, seen, controls, controls32 = [], set(), [], []
    for name, (n, h, w, cin, cout), dtype, route in cases:
        x, wt = conv_inputs(torch, gen, n, h, w, cin, cout, dtype,
                            misaligned="misaligned" in name)
        before = dict(kernels.conv3x3_bn_stats.launches_by_route)
        forced = isinstance(route, tuple)
        if forced:       # the tensor-core kernel launched with these tiles
            tiles, route = route, "tc"

            def run():
                return kernels._launch_conv_tc(x, wt, tiles)
        else:
            tiles = {"tc": kernels._conv_tiles(n * h * w, cout, sms),
                     "tf32x3": (64, 64)}.get(route)

            def run():
                return kernels.conv3x3_bn_stats(x, wt)
        y, s, q = run()
        torch.cuda.synchronize()
        took = [route] if forced else [
            r for r, k in kernels.conv3x3_bn_stats.launches_by_route.items()
            if k != before[r]]
        yr, sr, qr = kernels.conv3x3_bn_stats_reference(x, wt)
        s_err, q_err = rel_err(s, sr), rel_err(q, qr)
        ctl = None
        if route == "tf32x3":
            y_err = rel_err(y, yr)
            y_tol = s_tol = CONV_TF32X3_TOL
            why = (f"3xTF32: y, sum, sumsq within {CONV_TF32X3_TOL:g} of "
                   "max|ref| (the dropped lo x lo terms and f32 sums in "
                   "other orders); one TF32 pass must miss it")
            y_txt = f"y rel {y_err:.3e}"
            if name.startswith("fp32 resnet"):
                cy, cs, cq = one_tf32_pass(torch, kernels, x, wt)
                ctl = (rel_err(cy, yr), rel_err(cs, sr), rel_err(cq, qr))
                controls32.append(ctl)
                del cy, cs, cq
        elif dtype == f32:
            y_err, y_tol, s_tol = rel_err(y, yr), 1e-4, 1e-4
            why = ("fp32 on the CUDA cores: y, sum, sumsq within 1e-4 of "
                   "max|ref| (f32 sums in other orders)")
            y_txt = f"y rel {y_err:.3e}"
        else:
            y_err, y_tol, s_tol = ulp_err(torch, y, yr), 2.0, \
                CONV_STATS_TOL_16
            why = ("16-bit: y within 2 output ulps (one rounding of f32 "
                   "accumulators that differ in order), sums "
                   f"{CONV_STATS_TOL_16:g} rel")
            y_txt = f"y {y_err:.2f} ulp"
            ctl = rel_err(y.float().sum(dim=(0, 1, 2)), sr)
            if dtype == bf16 and route == "tc":
                controls.append(ctl)
        ok = (took == [route] and y.shape == yr.shape and y.dtype == dtype
              and bool(torch.isfinite(y.float()).all())
              and y_err <= y_tol and s_err <= s_tol and q_err <= s_tol)
        if ctl is None:
            extra = ""
        elif route == "tf32x3":
            extra = (", one-TF32-pass control y/sum/sumsq rel "
                     + "/".join(f"{e:.2e}" for e in ctl))
        else:
            extra = f", rounded-y control sum rel {ctl:.2e}"
        if (route, tiles) not in seen:
            seen.add((route, tiles))
            same = all(torch.equal(a, b) for a, b in zip((y, s, q), run()))
            extra += f"; second launch bitwise equal: {same}"
            ok = ok and same
        log(f"[b] conv {name:28s} {str((n, h, w, cin, cout)):22s} "
            f"{route}{'' if tiles is None else str(tiles)} {y_txt} "
            f"(tol {y_tol:g})  sum rel {s_err:.2e} sumsq rel {q_err:.2e} "
            f"(tol {s_tol:g}){extra}  {'ok' if ok else 'FAIL'}  -- {why}")
        if not ok:
            raise SystemExit(f"phase b: conv3x3_bn_stats disagrees with its "
                             f"plain version on '{name}' (route {took}, "
                             f"want {route})")
        records.append({"case": name, "route": route,
                        "tiles": None if tiles is None else list(tiles),
                        "y_err": y_err, "sum_rel": s_err,
                        "sumsq_rel": q_err,
                        ("one_pass_rel" if route == "tf32x3"
                         else "rounded_y_sum_rel"): ctl})
        del x, wt, y, s, q, yr, sr, qr
    tc = [r for r in records if r["route"] == "tc"]
    caught = min(controls) > CONV_STATS_TOL_16
    log(f"[b] conv 16-bit statistics limit {CONV_STATS_TOL_16:g}: the "
        f"tensor-core kernel reads at most "
        f"{max(r['sum_rel'] for r in tc):.2e} (sum), "
        f"{max(r['sumsq_rel'] for r in tc):.2e} (sumsq); statistics from "
        f"the rounded y read {min(controls):.2e}-{max(controls):.2e} (sum) "
        f"on the bf16 tensor-core cases: caught {caught}")
    if not caught:
        raise SystemExit("phase b: the 16-bit statistics limit would pass "
                         "statistics taken from the rounded y")
    t3 = [r for r in records if r["route"] == "tf32x3"]
    worst = max(max(r["y_err"], r["sum_rel"], r["sumsq_rel"]) for r in t3)
    # the control passes when all of its y, sum and sumsq are within
    caught32 = all(max(c) > CONV_TF32X3_TOL for c in controls32)
    log(f"[b] conv 3xTF32 limit {CONV_TF32X3_TOL:g}: the tf32x3 kernel reads "
        f"at most {worst:.2e} (y, sum, sumsq over {len(t3)} cases); one "
        f"TF32 pass reads y {min(c[0] for c in controls32):.2e}-"
        f"{max(c[0] for c in controls32):.2e}, sum "
        f"{min(c[1] for c in controls32):.2e}-"
        f"{max(c[1] for c in controls32):.2e}, sumsq "
        f"{min(c[2] for c in controls32):.2e}-"
        f"{max(c[2] for c in controls32):.2e} on the fp32 ResNet cases: "
        f"caught {caught32}")
    if not caught32:
        raise SystemExit("phase b: the 3xTF32 limit would pass one TF32 "
                         "pass")
    records.append(check_tf32x3_pack(torch, kernels, gen))
    records.append(check_conv_train(torch, kernels, gen))
    return records


def check_tf32x3_pack(torch, kernels, gen):
    """The 3xTF32 K3's weight pre-pass (TF32 hi and lo of w in (9, Cout,
    Cin) K-major panels) bitwise against its plain version, at ResNet-50's
    widest 3x3 weight and a Cin = 32 one."""
    same = []
    for cin, cout in ((512, 512), (32, 64)):
        w = torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
        got = kernels._launch_pack_w_tf32x3(w)
        want = kernels.conv_weight_tf32x3_pack_reference(w)
        same.append(torch.equal(got.view(torch.int32),
                                want.view(torch.int32)))
    log(f"[b] conv3x3_bn_stats_tf32x3 weight pre-pass (3, 3, 512, 512), "
        f"(3, 3, 32, 64) == its plain version bitwise: {same} "
        f"{'ok' if all(same) else 'FAIL'}")
    if not all(same):
        raise SystemExit("phase b: the 3xTF32 weight pre-pass differs from "
                         "its plain version")
    return {"case": "tf32x3 weight pre-pass", "bitwise": same}


def check_conv_train(torch, kernels, gen):
    """conv3x3_bn_relu_train (K3 forward, plain-op backward) against
    autograd through the plain composition, fp32, TF32 off."""
    import torch.nn.functional as F

    eps = 1e-3
    x, w = conv_inputs(torch, gen, 4, 14, 14, 64, 64, torch.float32)
    gamma = torch.rand(64, generator=gen, device="cuda") + 0.5
    beta = torch.randn(64, generator=gen, device="cuda")

    def plain(x, w, gamma, beta):
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     padding=1).permute(0, 2, 3, 1)
        mean = y.mean(dim=(0, 1, 2))
        var = torch.clamp_min((y * y).mean(dim=(0, 1, 2)) - mean ** 2, 0.0)
        inv = torch.rsqrt(var + eps) * gamma
        return torch.relu(y * inv + (beta - mean * inv))

    def run(fn):
        args = [t.clone().requires_grad_(True) for t in (x, w, gamma, beta)]
        out = fn(*args)
        out = out[0] if isinstance(out, tuple) else out
        (out * torch.cos(out)).sum().backward()
        return [out.detach()] + [a.grad for a in args]

    got = run(lambda *a: kernels.conv3x3_bn_relu_train(*a, eps=eps))
    want = run(plain)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    ok = max(errs) <= 1e-4
    log(f"[b] conv3x3_bn_relu_train fp32 (4, 14, 14, 64, 64): out, dx, dw, "
        f"dgamma, dbeta rel err {', '.join(f'{e:.2e}' for e in errs)} "
        f"(tol 1e-4: f32 sums in other orders) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase b: conv3x3_bn_relu_train gradients disagree")
    return {"case": "conv3x3_bn_relu_train fp32", "rel_errs": errs}


# ------------------------------------------------------------------ phase c
def device_ms(fn, n=20):
    """Device time of one call of ``fn``: ``n`` calls queued behind a
    spin kernel (torch.cuda._sleep), so the card runs them back to back
    whatever the host's enqueue time, timed by CUDA events around the n
    calls. Retried with a longer spin if the card reached the first event
    before the host had queued every call."""
    import torch

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        torch.cuda._sleep(int(2e7 * 2 ** attempt))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        ran_dry = a.query()
        b.synchronize()
        if not ran_dry:
            return a.elapsed_time(b) / n
    raise SystemExit("device_ms: the host could not stay ahead of the card")


def time_flash(torch, kernels):
    """K1 at the LM's shape (8, 12, 1024, 64), causal: the tensor-core
    kernel on contiguous bf16 q, k, v and on the LM's strided views of one
    qkv buffer; in fp32 the 3xTF32 kernel (the route fp32 callers take,
    contiguous and on the strided views) beside the CUDA-core kernel on
    the same inputs; the plain version and torch SDPA (bf16 and fp32).
    ``*_ms`` is device time (device_ms); ``*_call_ms`` is the median of
    CUDA events around one call, which also holds the host's enqueue time
    of that call."""
    import torch.nn.functional as F

    shape = (BATCH, HEADS, T, UNITS // HEADS)
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = flash_inputs(torch, gen, shape, torch.bfloat16, "contiguous")
    qkv = flash_inputs(torch, gen, shape, torch.bfloat16, "qkv")
    f32 = [x.float() for x in (q, k, v)]
    f32_qkv = flash_inputs(torch, gen, shape, torch.float32, "qkv")
    for name, args, want in (("bf16", (q, k, v), "tc"),
                             ("bf16 qkv views", qkv, "tc"),
                             ("fp32", f32, "tf32x3"),
                             ("fp32 qkv views", f32_qkv, "tf32x3")):
        before = dict(kernels.flash_attention.launches_by_route)
        kernels.flash_attention(*args, causal=True)
        took = [r for r, n in kernels.flash_attention.launches_by_route
                .items() if n != before[r]]
        if took != [want]:
            raise SystemExit(f"phase c: {name} took route {took}, want "
                             f"{want}")

    def tc():
        return kernels.flash_attention(q, k, v, causal=True)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    ms = device_ms(tc)
    strided_ms = device_ms(lambda: kernels.flash_attention(*qkv,
                                                           causal=True))
    scale = 1.0 / math.sqrt(shape[-1])
    tf32_ms = device_ms(lambda: kernels.flash_attention(*f32, causal=True))
    tf32_strided_ms = device_ms(lambda: kernels.flash_attention(
        *f32_qkv, causal=True))
    simt_fp32_ms = device_ms(lambda: kernels._launch_simt(
        *f32, True, scale, 0, 0), n=5)
    got = kernels.flash_attention(*f32, causal=True)
    tf32_err = (got - kernels.flash_attention_reference(
        *f32, causal=True)).abs().max().item()
    plain_ms = device_ms(lambda: kernels.flash_attention_reference(
        q, k, v, causal=True, return_lse=True), n=5)
    fp32_plain_ms = device_ms(lambda: kernels.flash_attention_reference(
        *f32, causal=True, return_lse=True), n=5)
    library_ms = device_ms(sdpa)
    fp32_library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        *f32, is_causal=True), n=5)
    call_ms, library_call_ms = median_ms(tc), median_ms(sdpa)
    flops, nbytes = attention_work(*shape, True, 2)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"[c] flash_attn_fwd_tc bf16 {shape} causal: kernel {ms:.4f} ms "
        f"device ({call_ms:.4f} ms events around one call), on the LM's "
        f"strided qkv views {strided_ms:.4f} ms; torch SDPA "
        f"{library_ms:.4f} ms device ({library_call_ms:.4f} ms around one "
        f"call), kernel / SDPA {ms / library_ms:.2f}x; plain "
        f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
        f"({flops:.3e} FLOP, {nbytes:.3e} B); kernel at "
        f"{bound_ms / ms:.2%} of bound, {flops / ms / 1e9:.2f} TFLOP/s")
    f32_flops, f32_bytes = attention_work(*shape, True, 4)
    t_bound, t_by, fma_ms = bound_tf32x3(f32_flops, f32_bytes)
    issued = k1_tf32x3_issued_flops(
        *shape, True, tf32x3_tiles(kernels, shape[-1])[0])
    log(f"[c] flash_attn_fwd_tf32x3 fp32 {shape} causal: kernel "
        f"{tf32_ms:.4f} ms device, on the LM's strided qkv views "
        f"{tf32_strided_ms:.4f} ms; CUDA-core K1 on the same inputs "
        f"{simt_fp32_ms:.4f} ms ({simt_fp32_ms / tf32_ms:.2f}x the 3xTF32 "
        f"one); torch SDPA fp32 (its memory-efficient kernel: 3xTF32 on "
        f"mma.sync) {fp32_library_ms:.4f} ms device, kernel / SDPA "
        f"{tf32_ms / fp32_library_ms:.2f}x; plain fp32 {fp32_plain_ms:.4f} "
        f"ms; bound {t_bound:.4f} ms by {t_by} (three TF32 passes of "
        f"{f32_flops:.3e} FLOP at 495 TFLOP/s; {f32_bytes:.3e} B; at the 67 "
        f"TFLOP/s f32 FMA peak {fma_ms:.4f} ms); kernel at "
        f"{t_bound / tf32_ms:.2%} of bound, {f32_flops / tf32_ms / 1e9:.2f} "
        f"TFLOP/s of the needed products, {issued / tf32_ms / 1e9:.2f} "
        f"TFLOP/s of the {issued:.3e} TF32 FLOP it issues; max|O - plain| "
        f"{tf32_err:.3e}")
    return {"ms": ms, "call_ms": call_ms, "strided_ms": strided_ms,
            "tf32x3_ms": tf32_ms, "tf32x3_strided_ms": tf32_strided_ms,
            "tf32x3_bound_ms": t_bound, "tf32x3_bound_by": t_by,
            "tf32x3_fma_bound_ms": fma_ms, "tf32x3_issued_flops": issued,
            "tf32x3_err": tf32_err, "fp32_flops": f32_flops,
            "fp32_bytes": f32_bytes,
            "simt_fp32_ms": simt_fp32_ms, "fp32_plain_ms": fp32_plain_ms,
            "fp32_library_ms": fp32_library_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_call_ms": library_call_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
            "bytes": nbytes}


def attention_bwd_work(b, h, t, d, causal, itemsize):
    """(FLOP, bytes) the attention backward needs for these inputs: five
    products over the visible (query, key) pairs (s, dO v^T, dv, dk, dq),
    2*D each; q, k, v, O, dO and the f32 lse read once, dq, dk, dv written
    once."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 5 * 2.0 * d * pairs * b * h
    nbytes = 8.0 * b * h * t * d * itemsize + 4.0 * b * h * t
    return flops, nbytes


def k2_issued_flops(b, h, t, d, causal, q_offset=0, k_offset=0):
    """Tensor-core FLOP the tensor-core K2 issues for these inputs, by its
    own tile walk (csrc/flash_attn_bwd_tc.cu): the dk/dv kernel's
    (64-key, 32-query) pairs that a warpgroup does not skip, six products
    each (S^T, dP^T, dV and dK as hi + lo), and the dq kernel's (64-query,
    64-key) pairs, four each (S, dP, dQ as hi + lo). Each warpgroup owns
    64 rows, whatever its CTA's size, so the walk is counted per 64."""
    bq, own, bk = 32, 128, 64
    shift = q_offset - k_offset
    n_tiles = -(-t // own)
    n_qb = -(-t // bq)
    kv_pairs = q_pairs = 0
    for k0 in range(0, n_tiles * own, own):
        first = k0 - shift
        qb0 = (0 if not causal or first <= 0 else
               n_qb if first >= t else first // bq)
        for kw0 in (k0, k0 + 64):
            kv_pairs += sum(1 for qb in range(qb0, n_qb)
                            if not causal or qb * bq + bq - 1 + shift >= kw0)
    for q0 in range(0, n_tiles * own, own):
        n_kb = -(-t // bk)
        if causal:
            last_key = q0 + min(own, t - q0) - 1 + shift
            n_kb = 0 if last_key < 0 else min(n_kb, last_key // bk + 1)
        for wg in (0, 1):
            last_seen = q0 + 64 * wg + shift
            q_pairs += sum(1 for i in range(n_kb)
                           if not causal or i * bk <= last_seen + 63)
    return (kv_pairs * 6 * bq + q_pairs * 4 * bk) * 2.0 * 64 * d * b * h


def time_flash_bwd(torch, kernels):
    """K2 at the LM's shape (8, 12, 1024, 64), causal, in device time
    (device_ms): bf16 on contiguous q, k, v, O, dO and on the LM's layout
    (q/k/v views of one qkv buffer, the tensor-core K1's O, a strided dO),
    the CUDA-core route on the same bf16 inputs, fp32 on its 3xTF32 route
    (contiguous and on the LM's layout) beside the CUDA-core route on the
    same inputs, the plain version (bf16 and fp32 inputs), and torch
    SDPA's backward alone (autograd.grad through one recorded SDPA
    forward, retained; bf16, and fp32, whose memory-efficient kernel is
    3xTF32 on mma.sync).
    ``call_ms``: the median of CUDA events around one call, host enqueue
    included."""
    import torch.nn.functional as F

    shape = (BATCH, HEADS, T, UNITS // HEADS)
    gen = torch.Generator(device="cuda").manual_seed(13)
    args = bwd_inputs(torch, kernels, gen, shape, torch.bfloat16,
                      "contiguous", True, 0, 0, False)[:6]
    lm_args = bwd_inputs(torch, kernels, gen, shape, torch.bfloat16, "qkv",
                         True, 0, 0, False)[:6]
    f32_args = bwd_inputs(torch, kernels, gen, shape, torch.float32,
                          "contiguous", True, 0, 0, False)[:6]
    f32_lm_args = bwd_inputs(torch, kernels, gen, shape, torch.float32,
                             "qkv", True, 0, 0, False)[:6]

    def k2(a=args):
        return kernels.flash_attention_backward(*a, causal=True)

    for name, a, want in (("bf16", args, "tc"), ("bf16 LM layout", lm_args,
                                                 "tc"),
                          ("fp32", f32_args, "tf32x3"),
                          ("fp32 LM layout", f32_lm_args, "tf32x3")):
        before = dict(kernels.flash_attention_backward.launches_by_route)
        k2(a)
        took = [r for r, n in kernels.flash_attention_backward
                .launches_by_route.items() if n != before[r]]
        if took != [want]:
            raise SystemExit(f"phase c: K2 {name} took route {took}, want "
                             f"{want}")
    scale = 1.0 / math.sqrt(shape[-1])

    q, k, v, _, _, dout = args
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    o_sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True)

    def sdpa_bwd():
        return torch.autograd.grad(o_sdpa, leaves, dout, retain_graph=True)

    f32_leaves = [x.detach().clone().requires_grad_(True)
                  for x in f32_args[:3]]
    o_sdpa32 = F.scaled_dot_product_attention(*f32_leaves, is_causal=True)

    def sdpa32_bwd():
        return torch.autograd.grad(o_sdpa32, f32_leaves, f32_args[5],
                                   retain_graph=True)

    ms = device_ms(k2)
    lm_ms = device_ms(lambda: k2(lm_args))
    fp32_ms = device_ms(lambda: k2(f32_args))
    fp32_lm_ms = device_ms(lambda: k2(f32_lm_args))
    simt_fp32_ms = device_ms(lambda: kernels._launch_bwd(
        *f32_args, None, True, scale, 0, 0, route="simt"), n=5)
    fp32_err = grads_err(torch, k2(f32_args),
                         kernels.flash_attention_backward_reference(
                             *f32_args, causal=True))
    simt_ms = device_ms(lambda: kernels._launch_bwd(
        *args, None, True, scale, 0, 0, route="simt"), n=5)
    plain_ms = device_ms(lambda: kernels.flash_attention_backward_reference(
        *args, causal=True), n=5)
    fp32_plain_ms = device_ms(
        lambda: kernels.flash_attention_backward_reference(*f32_args,
                                                           causal=True), n=5)
    library_ms = device_ms(sdpa_bwd)
    fp32_library_ms = device_ms(sdpa32_bwd, n=5)
    call_ms = median_ms(k2)
    flops, nbytes = attention_bwd_work(*shape, True, 2)
    issued = k2_issued_flops(*shape, True)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"[c] flash_attn_bwd_tc bf16 {shape} causal: kernel {ms:.4f} ms "
        f"device ({call_ms:.4f} ms events around one call), on the LM's "
        f"layout {lm_ms:.4f} ms; torch SDPA backward {library_ms:.4f} ms "
        f"device, kernel / SDPA {ms / library_ms:.2f}x; plain "
        f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
        f"({flops:.3e} FLOP, {nbytes:.3e} B); kernel at "
        f"{bound_ms / ms:.2%} of bound, {flops / ms / 1e9:.2f} TFLOP/s of "
        f"the five products, {issued / ms / 1e9:.2f} TFLOP/s of the "
        f"{issued:.3e} FLOP it issues ({issued / flops:.2f}x the five); "
        f"CUDA-core K2 on the same bf16 inputs {simt_ms:.4f} ms "
        f"({simt_ms / ms:.1f}x the tensor-core one)")
    f32_bytes = attention_bwd_work(*shape, True, 4)[1]
    t_bound, t_by, fma_ms = bound_tf32x3(flops, f32_bytes)
    t_issued = k2_tf32x3_issued_flops(
        *shape, True, tf32x3_tiles(kernels, shape[-1])[1])
    log(f"[c] flash_attn_bwd_tf32x3 fp32 {shape} causal: kernel "
        f"{fp32_ms:.4f} ms device, on the LM's layout {fp32_lm_ms:.4f} ms; "
        f"CUDA-core K2 on the same inputs {simt_fp32_ms:.4f} ms "
        f"({simt_fp32_ms / fp32_ms:.2f}x the 3xTF32 one); torch SDPA fp32 "
        f"backward (memory-efficient kernel, 3xTF32 on mma.sync) "
        f"{fp32_library_ms:.4f} ms device, kernel / SDPA "
        f"{fp32_ms / fp32_library_ms:.2f}x; plain fp32 {fp32_plain_ms:.4f} "
        f"ms; bound {t_bound:.4f} ms by {t_by} (three TF32 passes of "
        f"{flops:.3e} FLOP at 495 TFLOP/s; {f32_bytes:.3e} B; at the 67 "
        f"TFLOP/s f32 FMA peak {fma_ms:.4f} ms); kernel at "
        f"{t_bound / fp32_ms:.2%} of bound, {flops / fp32_ms / 1e9:.2f} "
        f"TFLOP/s of the five products, {t_issued / fp32_ms / 1e9:.2f} "
        f"TFLOP/s of the {t_issued:.3e} TF32 FLOP it issues; grads vs plain "
        f"{fp32_err:.3e} of max|ref|")
    del o_sdpa, leaves, o_sdpa32, f32_leaves
    return {"ms": ms, "call_ms": call_ms, "lm_layout_ms": lm_ms,
            "simt_ms": simt_ms, "fp32_ms": fp32_ms,
            "fp32_lm_layout_ms": fp32_lm_ms, "simt_fp32_ms": simt_fp32_ms,
            "fp32_err": fp32_err, "tf32x3_bound_ms": t_bound,
            "tf32x3_bound_by": t_by, "tf32x3_fma_bound_ms": fma_ms,
            "tf32x3_issued_flops": t_issued, "fp32_bytes": f32_bytes,
            "plain_ms": plain_ms,
            "fp32_plain_ms": fp32_plain_ms, "library_ms": library_ms,
            "fp32_library_ms": fp32_library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops, "issued_flops": issued,
            "tflops": flops / ms / 1e9, "issued_tflops": issued / ms / 1e9,
            "bytes": nbytes}


def conv_work(n, h, w, cin, cout, itemsize):
    """(FLOP, bytes) one K3 call needs: 2*9*N*H*W*Cin*Cout; x and w read
    once, y written once, the two f32 per-channel sums written once."""
    flops = 2.0 * 9 * n * h * w * cin * cout
    nbytes = itemsize * (n * h * w * (cin + cout) + 9.0 * cin * cout) \
        + 8.0 * cout
    return flops, nbytes


def bound(flops, nbytes):
    """(bound ms, 'bytes' or 'operations') at the H100's bf16 peaks."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations"


def bound_tf32x3(flops, nbytes):
    """(bound ms, 'bytes' or 'operations', FMA ms) of fp32 work on the
    H100: the least time at fp32 accuracy is three TF32 passes of the
    needed FLOP at the 495 TFLOP/s TF32 peak, or the bytes at 3.35 TB/s;
    FMA ms is the FLOP at the 67 TFLOP/s of f32 FMA on the CUDA cores."""
    t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "bytes" if t_bytes >= t_ops else "operations",
            flops / PEAK_FP32_FMA_FLOPS * 1e3)


def tf32x3_tiles(kernels, d):
    """The 3xTF32 kernels' tiles at head dimension d, as their libraries
    report them (flash_attn_*_tf32x3_tiles, from each source's Cfg): K1's
    (query rows a CTA, keys a tile) and K2's (rows a streamed tile, keys a
    dk/dv CTA, queries a dq CTA)."""
    import ctypes

    k1 = [ctypes.c_int() for _ in range(2)]
    k2 = [ctypes.c_int() for _ in range(3)]
    if kernels._tc_library("tf32x3").flash_attn_fwd_tf32x3_tiles(
            d, *map(ctypes.byref, k1)) or \
            kernels._bwd_tc_library("tf32x3").flash_attn_bwd_tf32x3_tiles(
                d, *map(ctypes.byref, k2)):
        raise SystemExit(f"the 3xTF32 kernels report no tiles for D={d}")
    return tuple(x.value for x in k1), tuple(x.value for x in k2)


def k1_tf32x3_issued_flops(b, h, t, d, causal, tiles):
    """TF32 FLOP the 3xTF32 K1 issues for these inputs by its own tile
    walk over its ``tiles`` (tf32x3_tiles): each 64-row warpgroup runs S =
    Q K^T and O += P V, three passes each, on every K tile it does not
    skip."""
    bq, bk = tiles
    pairs = 0
    for q0 in range(0, t, bq):
        n_kb = -(-t // bk)
        if causal:
            n_kb = min(n_kb, (q0 + min(bq, t - q0) - 1) // bk + 1)
        for r0 in range(q0, q0 + bq, 64):
            pairs += sum(1 for i in range(n_kb)
                         if not causal or i * bk <= r0 + 63)
    return pairs * 2 * 3 * 2.0 * 64 * bk * d * b * h


def k2_tf32x3_issued_flops(b, h, t, d, causal, tiles):
    """TF32 FLOP the 3xTF32 K2 issues by its tile walk over its ``tiles``
    (tf32x3_tiles): the dk/dv kernel's (64-key, BOX-query) pairs that a
    warpgroup does not skip, four products each (S^T, dP^T, dV, dK), and
    the dq kernel's (64-query, BOX-key) pairs, three each (S, dP, dQ);
    three passes each."""
    box, kv_rows, q_rows = tiles
    n_b = -(-t // box)
    kv_pairs = q_pairs = 0
    for k0 in range(0, t, kv_rows):
        qb0 = min(k0 // box, n_b) if causal else 0
        for kw0 in range(k0, k0 + kv_rows, 64):
            kv_pairs += sum(1 for qb in range(qb0, n_b)
                            if not causal or qb * box + box - 1 >= kw0)
    for q0 in range(0, t, q_rows):
        n_kb = n_b
        if causal:
            n_kb = min(n_kb, (q0 + min(q_rows, t - q0) - 1) // box + 1)
        for r0 in range(q0, q0 + q_rows, 64):
            q_pairs += sum(1 for i in range(n_kb)
                           if not causal or i * box <= r0 + 63)
    return (kv_pairs * 4 + q_pairs * 3) * 3 * 2.0 * 64 * box * d * b * h


def k3_tf32x3_issued_flops(n, h, w, cin, cout, bm):
    """TF32 FLOP the 3xTF32 K3 issues for these inputs with BM-row tiles
    (its library's conv3x3_tf32x3_block_m): every CTA's tile over K = 9
    Cin, the rows past M of the last M tile included, three passes (its 64
    channels a tile divide Cout)."""
    return 3 * 2.0 * (-(-(n * h * w) // bm) * bm) * cout * 9 * cin


def time_conv(torch, kernels):
    """K3 at each ResNet-50 3x3 shape, N=32, in device time (device_ms).
    bf16: the tensor-core kernel (whose route is asserted), the CUDA-core
    kernel on the same inputs, the plain version, cuDNN's conv alone
    (channels_last) and the unfused path of tools/bench_fused_conv_bn.py
    (cuDNN conv, then the port's batch_norm statistics and apply). fp32,
    on inputs of their own: the 3xTF32 kernel (route asserted) with the TF32
    FLOP it issues, the CUDA-core kernel on the same inputs, the plain
    version, cuDNN's conv with TF32 off and with TF32 on (one TF32 pass:
    less accurate, not the yardstick), and the fp32 unfused path (cuDNN,
    TF32 off, then batch_norm). ``call_ms`` is the median of CUDA events
    around one call of the tensor-core kernel, which also holds the host's
    enqueue time of that call."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import nn as ops_nn

    gen = torch.Generator(device="cuda").manual_seed(11)
    gen32 = torch.Generator(device="cuda").manual_seed(12)
    sms = kernels._sm_count(torch.cuda.current_device())
    rows = []
    for hw, c in RESNET_3X3:
        x, w = conv_inputs(torch, gen, CONV_N, hw, hw, c, c, torch.bfloat16)
        x_cf = x.permute(0, 3, 1, 2)           # channels_last NCHW view
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        ones = torch.ones(c, device="cuda")
        zeros = torch.zeros(c, device="cuda")
        shape = (CONV_N, hw, hw, c, c)
        before = kernels.conv3x3_bn_stats.launches_by_route["tc"]
        kernels.conv3x3_bn_stats(x, w)
        if kernels.conv3x3_bn_stats.launches_by_route["tc"] != before + 1:
            raise SystemExit(f"phase c: K3 at {shape} bf16 did not take the "
                             "tensor-core route")

        def unfused(x_cf=x_cf, w_cl=w_cl):
            y = F.conv2d(x_cf, w_cl, padding=1).permute(0, 2, 3, 1)
            return ops_nn.batch_norm(y, ones, zeros, zeros, ones, axis=3,
                                     _train=True)

        ms = device_ms(lambda: kernels.conv3x3_bn_stats(x, w))
        simt_ms = device_ms(lambda: kernels._launch_conv_simt(x, w), n=5)
        plain_ms = device_ms(
            lambda: kernels.conv3x3_bn_stats_reference(x, w), n=5)
        library_ms = device_ms(lambda: F.conv2d(x_cf, w_cl, padding=1))
        unfused_ms = device_ms(unfused)
        call_ms = median_ms(lambda: kernels.conv3x3_bn_stats(x, w))
        flops, nbytes = conv_work(CONV_N, hw, hw, c, c, 2)
        bound_ms, bound_by = bound(flops, nbytes)
        tiles = kernels._conv_tiles(CONV_N * hw * hw, c, sms)
        log(f"[c] conv3x3_bn_stats_tc bf16 {shape} tiles {tiles}: kernel "
            f"{ms:.4f} ms device ({call_ms:.4f} ms events around one call),"
            f" {flops / ms / 1e9:.2f} TFLOP/s, {bound_ms / ms:.2%} of bound "
            f"{bound_ms:.4f} ms by {bound_by} ({flops:.3e} FLOP, "
            f"{nbytes:.3e} B); CUDA-core K3 {simt_ms:.4f} ms "
            f"({simt_ms / ms:.1f}x the tensor-core one); plain "
            f"{plain_ms:.4f} ms; cuDNN conv alone {library_ms:.4f} ms "
            f"(kernel / cuDNN {ms / library_ms:.2f}x); unfused cuDNN conv + "
            f"batch_norm {unfused_ms:.4f} ms")
        del x, w, x_cf, w_cl

        # fp32: the route fp32 callers take
        x, w = conv_inputs(torch, gen32, CONV_N, hw, hw, c, c, torch.float32)
        x_cf = x.permute(0, 3, 1, 2)
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        before = kernels.conv3x3_bn_stats.launches_by_route["tf32x3"]
        kernels.conv3x3_bn_stats(x, w)
        if kernels.conv3x3_bn_stats.launches_by_route["tf32x3"] != \
                before + 1:
            raise SystemExit(f"phase c: K3 at {shape} fp32 did not take the "
                             "3xTF32 route")

        def cudnn_tf32(x_cf=x_cf, w_cl=w_cl):
            with torch.backends.cudnn.flags(
                    enabled=True, benchmark=torch.backends.cudnn.benchmark,
                    deterministic=torch.backends.cudnn.deterministic,
                    allow_tf32=True):
                return F.conv2d(x_cf, w_cl, padding=1)

        tf32x3_ms = device_ms(lambda: kernels.conv3x3_bn_stats(x, w))
        simt_fp32_ms = device_ms(lambda: kernels._launch_conv_simt(x, w),
                                 n=5)
        fp32_plain_ms = device_ms(
            lambda: kernels.conv3x3_bn_stats_reference(x, w), n=5)
        fp32_library_ms = device_ms(lambda: F.conv2d(x_cf, w_cl, padding=1))
        tf32_library_ms = device_ms(cudnn_tf32)
        fp32_unfused_ms = device_ms(
            lambda: unfused(x_cf=x_cf, w_cl=w_cl))
        flops32, nbytes32 = conv_work(CONV_N, hw, hw, c, c, 4)
        bound32_ms, bound32_by, fma_ms = bound_tf32x3(flops32, nbytes32)
        bm32 = kernels._conv_tf32x3_library().conv3x3_tf32x3_block_m()
        issued = k3_tf32x3_issued_flops(CONV_N, hw, hw, c, c, bm32)
        log(f"[c] conv3x3_bn_stats_tf32x3 fp32 {shape} tiles ({bm32}, 64): "
            f"kernel {tf32x3_ms:.4f} ms device, "
            f"{flops32 / tf32x3_ms / 1e9:.2f} TFLOP/s of the needed "
            f"products, {issued / tf32x3_ms / 1e9:.2f} TFLOP/s of the "
            f"{issued:.3e} TF32 FLOP it issues, {bound32_ms / tf32x3_ms:.2%}"
            f" of the 3xTF32 bound {bound32_ms:.4f} ms by {bound32_by} "
            f"(f32 FMA {fma_ms:.4f} ms; {nbytes32:.3e} B); CUDA-core K3 "
            f"{simt_fp32_ms:.4f} ms ({simt_fp32_ms / tf32x3_ms:.2f}x the "
            f"3xTF32 one); plain {fp32_plain_ms:.4f} ms; cuDNN fp32 conv "
            f"alone, TF32 off {fp32_library_ms:.4f} ms (kernel / cuDNN "
            f"{tf32x3_ms / fp32_library_ms:.2f}x); cuDNN with TF32 on (one "
            f"TF32 pass, less accurate: not the yardstick) "
            f"{tf32_library_ms:.4f} ms; fp32 unfused cuDNN conv (TF32 off) "
            f"+ batch_norm {fp32_unfused_ms:.4f} ms (kernel / unfused "
            f"{tf32x3_ms / fp32_unfused_ms:.2f}x)")
        rows.append({"shape": list(shape), "tiles": list(tiles), "ms": ms,
                     "call_ms": call_ms, "simt_ms": simt_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "unfused_ms": unfused_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "flops": flops, "bytes": nbytes,
                     "tf32x3_tiles": [bm32, 64], "tf32x3_ms": tf32x3_ms,
                     "simt_fp32_ms": simt_fp32_ms,
                     "fp32_plain_ms": fp32_plain_ms,
                     "fp32_library_ms": fp32_library_ms,
                     "tf32_library_ms": tf32_library_ms,
                     "fp32_unfused_ms": fp32_unfused_ms,
                     "tf32x3_bound_ms": bound32_ms,
                     "tf32x3_bound_by": bound32_by, "fma_ms": fma_ms,
                     "fp32_bytes": nbytes32, "tf32x3_issued_flops": issued})
        del x, w, x_cf, w_cl
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ phase d
def serve_slice(torch, mx, kernels):
    import numpy as np

    from mxnet_tpu_torch import capture, serving
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    gen = torch.Generator(device="cuda").manual_seed(0)
    net = transformer.transformer_lm(
        vocab=VOCAB, units=UNITS, num_heads=HEADS, num_layers=LAYERS,
        max_len=T, impl="flash", prefix="tlm_")
    net.initialize(mx.init.Xavier(), generator=gen)   # default ctx: gpu(0)
    net.cast("bfloat16")
    # the main path: building the predictor captures each bucket's graph
    # (K1 enqueued at 2 warm-up runs and the capture), serving replays them
    zero_counts(kernels)
    t0 = time.perf_counter()
    pred = serving.Predictor.from_block(
        net, input_shapes={"data": (T,)}, batch_sizes=(1, 2, 4, 8),
        warmup=False).warmup(dtype="int64")     # token ids pass uncast
    built = dict(kernels.flash_attention.launches_by_route)
    log(f"[d] model built (bf16, {LAYERS} layers, {UNITS} units, {HEADS} "
        f"heads, vocab {VOCAB}, T {T}); warm-up and capture of buckets "
        f"{pred.buckets} {time.perf_counter() - t0:.2f} s; K1 enqueued "
        f"{built}")

    rng = np.random.RandomState(0)
    n_threads, per_thread = 4, 16
    requests = [[rng.randint(0, VOCAB, (1, T)).astype(np.int64)
                 for _ in range(per_thread)] for _ in range(n_threads)]
    results = [[None] * per_thread for _ in range(n_threads)]

    serving.reset_stats()
    graphs = pred._exec.compiled_signatures
    captured = capture.stats()
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
    by_route = dict(kernels.flash_attention.launches_by_route)
    st = serving.stats()
    replays = capture.stats()["capture_hits"] - captured["capture_hits"]
    new_graphs = capture.stats()["capture_misses"] - \
        captured["capture_misses"]
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
        f"flash launches {launches} (by route {by_route})")
    want = LAYERS * 3 * len(pred.buckets)
    if calls < 1 or by_route != built or built != {"tc": want, "tf32x3": 0,
                                                   "simt": 0}:
        raise SystemExit(f"phase d: {launches} flash launches {by_route} "
                         f"for {calls} predict calls (want {LAYERS} "
                         "tensor-core launches at each bucket's 2 warm-up "
                         "runs and capture, none on the CUDA cores and none "
                         "at a replay)")
    # the served run only replayed the bucket graphs built above, and each
    # of them holds the 12 tensor-core K1 launches as kernel nodes
    nodes = {sig[0][0][0]: graph_nodes(
        pred._exec, f"lm_bucket_{sig[0][0][0]}",
        ("flash_fwd_tc_kernel", "flash_fwd_kernel"), sig) for sig in graphs}
    log(f"[d] served by {replays} graph replays and {new_graphs} new "
        "captures; K1 kernel nodes per bucket graph (tensor-core, "
        "CUDA-core): " + ", ".join(
            f"{b}: ({n['flash_fwd_tc_kernel']}, {n['flash_fwd_kernel']})"
            for b, n in sorted(nodes.items())))
    if (new_graphs or replays != calls
            or pred._exec.compiled_signatures != graphs
            or sorted(nodes) != sorted(pred.buckets)
            or any(n["flash_fwd_tc_kernel"] != LAYERS or n["flash_fwd_kernel"]
                   for n in nodes.values())):
        raise SystemExit(f"phase d: {calls} predict calls served by "
                         f"{replays} replays and {new_graphs} new captures; "
                         f"K1 nodes {nodes} (want {LAYERS} tensor-core K1 "
                         "nodes in every bucket graph, none on the CUDA "
                         "cores)")

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
    breakdown = profile_predict(torch, pred, np.concatenate(batch, axis=0),
                                kernel=("flash_fwd_tc_kernel",
                                        "flash_fwd_kernel"))
    copies = [(r["kernel"], r["count"]) for r in breakdown["all"]
              if any(k in r["kernel"] for k in _COPY_KERNELS)]
    n_copies = sum(c for _, c in copies)
    log(f"[d] copy kernels in one bucket-8 predict: {n_copies} launches "
        f"({', '.join(f'{k[:70]} x{c}' for k, c in copies) or 'none'})")
    if n_copies >= LAYERS:
        raise SystemExit("phase d: the LM still copies per layer (q/k/v or "
                         "the head merge)")
    breakdown["copy_launches"] = n_copies
    del results, served, direct, pred, net
    torch.cuda.empty_cache()
    return {"breakdown": breakdown, "requests": n_req, "wall_s": wall,
            "requests_per_s": n_req / wall, "tokens_per_s": n_req * T / wall,
            "p50_ms": st["serving_p50_latency_us"] / 1e3,
            "p99_ms": st["serving_p99_latency_us"] / 1e3,
            "batches": st["serving_batches"], "predict_calls": calls,
            "launches": launches, "launches_by_route": by_route,
            "graph_replays": replays,
            "k1_graph_nodes": {b: n["flash_fwd_tc_kernel"]
                               for b, n in nodes.items()}}


def profile_predict(torch, pred, ids, phase="d", kernel="flash_fwd"):
    """Device time by kernel for one predict of ``ids`` (after a warm-up
    predict), from torch.profiler: where the slice's time goes. ``kernel``
    (a name part, or a tuple of them) picks the kernels whose share is
    reported."""
    pred.predict(ids)
    torch.cuda.synchronize()
    return profile_window(torch, lambda: pred.predict(ids),
                          f"one bucket-{len(ids)} predict", phase, kernel)


def profile_window(torch, fn, label, phase, kernel, top=8):
    """Device time by kernel for one call of ``fn``, from torch.profiler,
    with the wall time of the call (ended by a synchronise)."""
    parts = (kernel,) if isinstance(kernel, str) else kernel
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    kernel_ms = sum(r[0] for r in rows if any(p in r[2] for p in parts))
    log(f"[{phase}] profile of {label}: wall {wall_ms:.3f} ms (profiler "
        f"on), device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%} of "
        f"wall), {sum(r[1] for r in rows)} kernel launches, "
        f"{'/'.join(parts)} {kernel_ms:.3f} ms ({kernel_ms / busy_ms:.1%} of "
        "device time)"
        if busy_ms else f"[{phase}] profile: no device time recorded (not "
        "measured)")
    for ms, count, key in rows[:top]:
        log(f"[{phase}]   {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "kernel": "/".join(parts), "kernel_ms": kernel_ms,
            "launches": sum(r[1] for r in rows),
            "top": [{"ms": ms, "count": c, "kernel": k[:120]}
                    for ms, c, k in rows[:top]],
            "all": [{"ms": ms, "count": c, "kernel": k[:120]}
                    for ms, c, k in rows]}


# ------------------------------------------------------------------ phase e
def model_vs_plain(torch, mx, kernels):
    """A 2-layer model of the slice's widths with the flash kernel against
    the same weights with plain attention: in fp32 (the 3xTF32 kernel on
    the model's strided q/k/v; max abs error within 1e-3) and in bf16 (the
    tensor-core kernel on the same views; max abs error within 3e-2 of
    max|logits|).
    Returns {dtype: error}."""
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
    errs = {}
    for dtype, route in (("float32", "tf32x3"), ("bfloat16", "tc")):
        if dtype != "float32":
            for net in nets.values():
                net.cast(dtype)
        before = dict(kernels.flash_attention.launches_by_route)
        with torch.inference_mode():
            a = nets["flash"](ids).float()
            b = nets["dense"](ids).float()
        took = {r: n - before[r] for r, n in
                kernels.flash_attention.launches_by_route.items()}
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        if dtype == "float32":
            tol, why = 1e-3, (f"tol 1e-3: reordered f32 sums through 2 "
                              f"layers and a {UNITS}-wide head")
        else:
            tol, why = 3e-2 * scale, (
                f"tol 3e-2 of max|logits| {scale:.4f}: every layer rounds "
                "its activations to bf16 (2^-8), and the plain path also "
                "rounds its attention logits and probabilities")
        ok = (bool(torch.isfinite(a).all()) and err <= tol
              and took[route] == 2 and sum(took.values()) == 2)
        log(f"[e] 2-layer {dtype} model, flash kernel ({route}: {took}) vs "
            f"plain attention: logits max abs err {err:.3e} ({why}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase e: {dtype} model logits disagree")
        errs[dtype] = err
    return errs


# ------------------------------------------------------------------ phase f
def serve_resnet(torch, mx):
    """ResNet-50 v1 (NHWC, s2d stem, 1000 classes) at full depth and width
    in bf16, behind Predictor + BatchServer, served to 4 threads x 32
    single-image requests. Returns the measurements and what phase g needs
    (the predictor, the net and one bucket-32 batch)."""
    import numpy as np

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon.model_zoo import vision

    gen = torch.Generator(device="cuda").manual_seed(0)
    net = vision.resnet50_v1(layout="NHWC", stem="s2d", classes=1000)
    # Xavier over fan-in only: with OHWI weights its fan-out would read the
    # wrong axes (the reference initializer's rule), shrinking every layer
    net.initialize(mx.init.Xavier(factor_type="in", magnitude=2),
                   generator=gen)                   # default ctx: gpu(0)
    net.cast("bfloat16")
    t0 = time.perf_counter()
    pred = serving.Predictor.from_block(
        net, input_shapes={"data": (3, 224, 224)}, batch_sizes=(1, 8, 32),
        dtype="bfloat16")
    log(f"[f] resnet50_v1 NHWC s2d built (bf16, "
        f"{sum(t.numel() for t in net.collect_params().values())} "
        f"parameters); warmup of buckets {pred.buckets} "
        f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.RandomState(0)
    n_threads, per_thread = 4, 32
    requests = [[rng.rand(1, 3, 224, 224).astype(np.float32)
                 for _ in range(per_thread)] for _ in range(n_threads)]
    results = [[None] * per_thread for _ in range(n_threads)]
    serving.reset_stats()
    with serving.BatchServer(pred, max_batch_size=32,
                             batch_timeout_ms=5.0) as server:
        def client(i):
            futs = [server.submit(img) for img in requests[i]]
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
    st = serving.stats()
    n_req = n_threads * per_thread
    if any(th.is_alive() for th in threads):
        raise SystemExit("phase f: a client thread did not finish")
    for row in results:
        for r in row:
            logits = r[0]
            if tuple(logits[0].shape) != (1000,):
                raise SystemExit(f"phase f: result shape {logits.shape}")
            if not bool(torch.isfinite(logits).all()):
                raise SystemExit("phase f: non-finite logits")
    log(f"[f] served {n_req} images from {n_threads} threads in "
        f"{st['serving_batches']} batches ({st['serving_predict_calls']} "
        f"predict calls, {st['serving_padded_samples']} padded rows): "
        f"{n_req / wall:.3f} images/s, "
        f"p50 {st['serving_p50_latency_us'] / 1e3:.2f} ms, "
        f"p99 {st['serving_p99_latency_us'] / 1e3:.2f} ms")

    # a request coalesced into one full bucket-32 batch equals its row of
    # predict on the same bucket, bitwise
    batch = requests[0]
    with serving.BatchServer(pred, max_batch_size=32,
                             batch_timeout_ms=10000.0) as server:
        futs = [server.submit(img) for img in batch]
        served = [f.result(timeout=600)[0] for f in futs]
    images = np.concatenate(batch, axis=0)
    direct = pred.predict(images)[0]
    same = all(torch.equal(served[j][0], direct[j]) for j in range(32))
    log(f"[f] batched request == its row of predict (bucket 32): {same}; "
        f"logits max |x| {direct.float().abs().max().item():.4e}")
    if not same:
        raise SystemExit("phase f: batched result differs from predict")
    predict_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred.predict(images)
        torch.cuda.synchronize()
        predict_ms.append((time.perf_counter() - t0) * 1e3)
    predict_ms = sorted(predict_ms)[2]
    log(f"[f] bucket-32 predict, host clock, profiler off: median of 5 "
        f"{predict_ms:.3f} ms ({32e3 / predict_ms:.1f} images/s with no "
        "batching or client threads)")
    breakdown = profile_predict(torch, pred, images, phase="f",
                                kernel=("fprop", "implicit_gemm", "conv"))
    measured = {"breakdown": breakdown, "requests": n_req, "wall_s": wall,
                "images_per_s": n_req / wall, "predict32_ms": predict_ms,
                "p50_ms": st["serving_p50_latency_us"] / 1e3,
                "p99_ms": st["serving_p99_latency_us"] / 1e3,
                "batches": st["serving_batches"],
                "predict_calls": st["serving_predict_calls"],
                "padded_rows": st["serving_padded_samples"]}
    return measured, (pred, net, images)


# ------------------------------------------------------------------ phase g
_COPY_KERNELS = ("copy", "nchwToNhwc", "nhwcToNchw", "transpose",
                 "Transpose")


def conv_on_model(torch, kernels, pred, net, images):
    """K3 fed the served model's own tensors: the input and weight of the
    3x3 conv (body[3]) of each stage's first bottleneck, captured by
    forward hooks during one bucket-32 forward of the net (a predict
    replays its graph, where no hook runs). Returns the launches and
    errors of that main path."""
    stages = [blk for blk in net.features
              if blk.prefix.endswith(tuple(f"stage{i}_"
                                           for i in range(1, 5)))]
    convs = [list(list(stage)[0].body)[3] for stage in stages]
    captured = []
    hooks = [c.register_forward_hook(
        lambda mod, inp, out: captured.append((inp[0], mod.weight, out)))
        for c in convs]
    try:
        with torch.inference_mode():
            net(torch.from_numpy(images).to("cuda", torch.bfloat16))
    finally:
        for h in hooks:
            h.remove()
    if len(captured) != 4:
        raise SystemExit(f"phase g: captured {len(captured)} convs, want 4")

    with torch.inference_mode():
        weights = [w.permute(1, 2, 3, 0).contiguous() for _, w, _ in captured]
        zero_counts(kernels)
        fused = [kernels.conv3x3_bn_stats(x, w)
                 for (x, _, _), w in zip(captured, weights)]
        torch.cuda.synchronize()
        launches = kernels.conv3x3_bn_stats.launches
        by_route = dict(kernels.conv3x3_bn_stats.launches_by_route)
        max_abs, records = 0.0, []
        for (x, _, y_lib), w, (y, s, q) in zip(captured, weights, fused):
            yr, sr, qr = kernels.conv3x3_bn_stats_reference(x, w)
            lib_ulp, plain_ulp = ulp_err(torch, y, y_lib), ulp_err(torch, y,
                                                                    yr)
            s_err, q_err = rel_err(s, sr), rel_err(q, qr)
            max_abs = max(max_abs, (y.float() - yr.float()).abs().max()
                          .item())
            ok = lib_ulp <= 4 and plain_ulp <= 2 and max(s_err, q_err) \
                <= CONV_STATS_TOL_16
            log(f"[g] K3 on the model's {tuple(x.shape)} -> "
                f"{tuple(y.shape)}: vs cuDNN's output {lib_ulp:.2f} ulp "
                f"(tol 4: its own f32 order), vs plain {plain_ulp:.2f} ulp "
                f"(tol 2), sum rel {s_err:.2e} sumsq rel {q_err:.2e} "
                f"(tol {CONV_STATS_TOL_16:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("phase g: K3 disagrees on the model's "
                                 "tensors")
            records.append({"shape": list(x.shape), "vs_cudnn_ulp": lib_ulp,
                            "vs_plain_ulp": plain_ulp, "sum_rel": s_err,
                            "sumsq_rel": q_err})
    log(f"[g] conv3x3_bn_stats launches on the model's tensors: {launches} "
        f"by route {by_route} (want 4, all tensor-core)")
    if launches != 4 or by_route != {"tc": 4, "tf32x3": 0, "simt": 0}:
        raise SystemExit(f"phase g: {launches} K3 launches {by_route}, want "
                         "4 on the tensor-core route")

    copies, n_convs = conv_layer_copies(torch, net, images)
    n_copies = sum(c for _, c in copies)
    log(f"[g] copy/layout kernels when the model's {n_convs} conv layers "
        f"run alone on their own inputs: {n_copies} launches "
        f"({', '.join(f'{k[:70]} x{c}' for k, c in copies) or 'none'})")
    if n_copies >= n_convs:
        raise SystemExit("phase g: a conv layer inserts a copy per conv")
    return {"launches": launches, "launches_by_route": by_route,
            "max_abs_err": max_abs, "checks": records,
            "copy_launches": n_copies, "copies": copies, "convs": n_convs}


def conv_on_fp32_model(torch, mx, kernels, images):
    """K3 fed an fp32 ResNet-50's own tensors (NHWC, s2d stem, seeded
    Xavier as phase f's model, left in fp32, mxnet_tpu's default dtype):
    the input and weight of each stage's first 3x3 conv, captured by
    forward hooks during one bucket-32 forward. Exactly 4 launches, all on
    the 3xTF32 route, each within the 3xTF32 limit of the plain version and
    of cuDNN's own output. Returns the launches and errors of that path."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    gen = torch.Generator(device="cuda").manual_seed(0)
    net = vision.resnet50_v1(layout="NHWC", stem="s2d", classes=1000,
                             prefix="r50fp32_")
    net.initialize(mx.init.Xavier(factor_type="in", magnitude=2),
                   generator=gen)
    stages = [blk for blk in net.features
              if blk.prefix.endswith(tuple(f"stage{i}_"
                                           for i in range(1, 5)))]
    convs = [list(list(stage)[0].body)[3] for stage in stages]
    captured = []
    hooks = [c.register_forward_hook(
        lambda mod, inp, out: captured.append((inp[0], mod.weight, out)))
        for c in convs]
    try:
        with torch.inference_mode():
            logits = net(torch.from_numpy(images).to("cuda", torch.float32))
    finally:
        for h in hooks:
            h.remove()
    if len(captured) != 4 or logits.dtype != torch.float32 or not bool(
            torch.isfinite(logits).all()):
        raise SystemExit(f"phase g: the fp32 model gave {len(captured)} "
                         f"convs (want 4) and {logits.dtype} logits")

    with torch.inference_mode():
        weights = [w.permute(1, 2, 3, 0).contiguous() for _, w, _ in captured]
        zero_counts(kernels)
        fused = [kernels.conv3x3_bn_stats(x, w)
                 for (x, _, _), w in zip(captured, weights)]
        torch.cuda.synchronize()
        launches = kernels.conv3x3_bn_stats.launches
        by_route = dict(kernels.conv3x3_bn_stats.launches_by_route)
        max_abs, records = 0.0, []
        for (x, _, y_lib), w, (y, s, q) in zip(captured, weights, fused):
            yr, sr, qr = kernels.conv3x3_bn_stats_reference(x, w)
            lib_err, plain_err = rel_err(y, y_lib), rel_err(y, yr)
            s_err, q_err = rel_err(s, sr), rel_err(q, qr)
            max_abs = max(max_abs, (y - yr).abs().max().item())
            ok = y.dtype == torch.float32 and max(
                lib_err, plain_err, s_err, q_err) <= CONV_TF32X3_TOL
            log(f"[g] K3 on the fp32 model's {tuple(x.shape)} -> "
                f"{tuple(y.shape)}: vs cuDNN's fp32 output (TF32 off) "
                f"{lib_err:.2e} of max|y|, vs plain {plain_err:.2e}, sum rel "
                f"{s_err:.2e} sumsq rel {q_err:.2e} (tol "
                f"{CONV_TF32X3_TOL:g}: phase b's 3xTF32 limit; cuDNN's fp32 "
                f"conv, the plain version's own, is accurate to ~1e-6) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("phase g: K3 disagrees on the fp32 model's "
                                 "tensors")
            records.append({"shape": list(x.shape), "vs_cudnn_rel": lib_err,
                            "vs_plain_rel": plain_err, "sum_rel": s_err,
                            "sumsq_rel": q_err})
    log(f"[g] conv3x3_bn_stats launches on the fp32 model's tensors: "
        f"{launches} by route {by_route} (want 4, all 3xTF32)")
    if launches != 4 or by_route != {"tc": 0, "tf32x3": 4, "simt": 0}:
        raise SystemExit(f"phase g: {launches} K3 launches {by_route} on the "
                         "fp32 model, want 4 on the 3xTF32 route")
    del net, captured, fused
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_by_route": by_route,
            "max_abs_err": max_abs, "checks": records}


def conv_layer_copies(torch, net, images):
    """[(kernel, launches)] of copy or layout-transform kernels launched
    when each Conv2D layer of ``net`` runs on the input it saw in one
    predict, and the number of conv layers. NHWC convs hand cuDNN
    channels_last views, so none should copy its activation."""
    from torch.profiler import ProfilerActivity, profile

    layers = [m for m in net.modules() if type(m).__name__ == "Conv2D"]
    inputs = {}

    def keep_input(mod, inp, out):      # returns None: the output stands
        inputs[mod] = inp[0]

    hooks = [m.register_forward_hook(keep_input) for m in layers]
    try:
        with torch.inference_mode():
            net(torch.from_numpy(images).to("cuda", layers[0].weight.dtype))
    finally:
        for h in hooks:
            h.remove()
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for m in layers:
                m(inputs[m])
            torch.cuda.synchronize()
    found = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and any(
                k in evt.key for k in _COPY_KERNELS):
            found[evt.key] = found.get(evt.key, 0) + evt.count
    return sorted(found.items()), len(layers)


def resnet_layouts(torch, mx):
    """An fp32 NHWC conv7 ResNet-50 and the same weights in NCHW
    (OHWI -> OIHW) give the same logits on 2 images, TF32 off."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    gen = torch.Generator(device="cuda").manual_seed(5)
    nhwc = vision.resnet50_v1(layout="NHWC", stem="conv7", prefix="r50_")
    nchw = vision.resnet50_v1(layout="NCHW", stem="conv7", prefix="r50_")
    nhwc.initialize(mx.init.Xavier(factor_type="in", magnitude=2),
                    generator=gen)
    nchw.initialize(mx.init.Zero())
    target = nchw._param_objects()
    for name, p in nhwc._param_objects().items():
        t = p.data()
        target[name].set_data(t.permute(0, 3, 1, 2) if t.dim() == 4 else t)
    x = torch.rand((2, 3, 224, 224), generator=gen, device="cuda")
    with torch.inference_mode():
        a, b = nhwc(x), nchw(x)
    err = rel_err(a, b)
    ok = bool(torch.isfinite(a).all()) and a.shape == (2, 1000) \
        and err <= 1e-3
    log(f"[g] fp32 resnet50_v1 conv7 NHWC vs NCHW (same weights): logits "
        f"max abs err / max |logit| {err:.3e} (tol 1e-3: f32 convs in other "
        f"algorithms through 53 layers; max |logit| "
        f"{b.abs().max().item():.4e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase g: NHWC and NCHW logits disagree")
    return err


# ------------------------------------------------------------------ phase h
TRAIN_STEPS = 10
LR = 1e-3


def lm_batch(torch, batch, t, vocab, seed=0):
    """One fixed batch of the learnable sequence x_{t+1} = (5 x_t + 3) mod
    vocab (examples/transformer_lm.py:84-88): ids and next-token labels,
    (batch, t) int64 on the card."""
    import numpy as np

    rng = np.random.RandomState(seed)
    seq = np.zeros((batch, t + 1), np.int64)
    seq[:, 0] = rng.randint(0, vocab, batch)
    for i in range(t):
        seq[:, i + 1] = (5 * seq[:, i] + 3) % vocab
    return (torch.from_numpy(seq[:, :-1]).cuda(),
            torch.from_numpy(seq[:, 1:]).cuda())


def zero_counts(kernels):
    from mxnet_tpu_torch.ops import decode_attention

    for fn in (kernels.flash_attention, kernels.flash_attention_backward,
               kernels.conv3x3_bn_stats,
               decode_attention.paged_decode_attention):
        fn.launches = 0
        for route in fn.launches_by_route:
            fn.launches_by_route[route] = 0
    decode_attention.kv_quantize_write.launches = 0


_STEP_GROUPS = (("K1 flash_fwd", ("flash_fwd",)),
                ("K2 flash_bwd", ("flash_bwd",)),
                ("GEMMs", ("gemm", "nvjet", "cutlass", "xmma")),
                ("softmax / log_softmax", ("softmax", "SoftMax")),
                ("copies", _COPY_KERNELS))


def step_breakdown(rows):
    """{group: (device ms, launches)} of a profile's kernels, by name."""
    out, rest = {}, [0.0, 0]
    for r in rows:
        for group, parts in _STEP_GROUPS:
            if any(p in r["kernel"] for p in parts):
                ms, n = out.get(group, (0.0, 0))
                out[group] = (ms + r["ms"], n + r["count"])
                break
        else:
            rest[0] += r["ms"]
            rest[1] += r["count"]
    out["other (elementwise, reductions, layer norm, GELU, embedding)"] = \
        tuple(rest)
    return out


def train_slice(torch, mx, kernels):
    """The training step at GPT-2-small widths, full depth, bf16: B=8,
    T=1024, seeded Xavier weights, Adam (lr 1e-3, weights and states in
    bf16 as mxnet_tpu keeps them), SoftmaxCrossEntropyLoss, 10 steps on one
    fixed batch of the learnable sequence. Asserts finite losses, a loss
    10 at least 0.5 below loss 1, and exactly 12 tensor-core K1 and 12 K2
    launches per step; then profiles one more step (forward + backward,
    and the Adam update, as two windows)."""
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    gen = torch.Generator(device="cuda").manual_seed(0)
    net = transformer.transformer_lm(
        vocab=VOCAB, units=UNITS, num_heads=HEADS, num_layers=LAYERS,
        max_len=T, impl="flash", prefix="tlm_")
    net.initialize(mx.init.Xavier(), generator=gen)   # default ctx: gpu(0)
    net.cast("bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = lm_batch(torch, BATCH, T, VOCAB)

    def forward_backward():
        with mx.autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        return loss

    zero_counts(kernels)
    losses, step_ms, per_step = [], [], []
    for i in range(TRAIN_STEPS):
        k1 = dict(kernels.flash_attention.launches_by_route)
        k2 = dict(kernels.flash_attention_backward.launches_by_route)
        t0 = time.perf_counter()
        loss = forward_backward()
        trainer.step(1)
        losses.append(loss.item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append((
            {r: n - k1[r] for r, n in
             kernels.flash_attention.launches_by_route.items()},
            {r: n - k2[r] for r, n in
             kernels.flash_attention_backward.launches_by_route.items()}))
        log(f"[h] step {i + 1}: loss {losses[-1]:.4f}, {step_ms[-1]:.2f} ms "
            f"(host clock), K1 {per_step[-1][0]}, K2 {per_step[-1][1]}")
    k1_total = kernels.flash_attention.launches
    k1_by_route = dict(kernels.flash_attention.launches_by_route)
    k2_total = kernels.flash_attention_backward.launches
    k2_by_route = dict(kernels.flash_attention_backward.launches_by_route)
    timed = sorted(step_ms[1:])
    median = timed[len(timed) // 2]
    tokens_per_s = BATCH * T / (median / 1e3)
    drop = losses[0] - losses[-1]
    ok = (all(math.isfinite(v) for v in losses) and drop >= 0.5
          and all(k1 == k2 == {"tc": LAYERS, "tf32x3": 0, "simt": 0}
                  for k1, k2 in per_step))
    log(f"[h] {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(drop {drop:.4f}, want >= 0.5); median step {median:.2f} ms over "
        f"steps 2-{TRAIN_STEPS} (host clock, profiler off), "
        f"{tokens_per_s:.1f} tokens/s; K1 launches {k1_total} "
        f"{k1_by_route}, K2 launches {k2_total} {k2_by_route} (want "
        f"{LAYERS} tensor-core K1 and {LAYERS} tensor-core K2 a step) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase h: the training step failed its checks")

    torch.cuda.synchronize()
    fb = profile_window(torch, forward_backward, "one step's forward + "
                        "backward", "h", ("flash_fwd", "flash_bwd"), top=12)
    upd = profile_window(torch, lambda: trainer.step(1), "one step's Adam "
                         "update", "h", ("elementwise", "vectorized"))
    groups = step_breakdown(fb["all"])
    groups["Adam update (all its kernels)"] = (upd["device_busy_ms"],
                                               upd["launches"])
    busy = fb["device_busy_ms"] + upd["device_busy_ms"]
    wall = fb["wall_ms"] + upd["wall_ms"]
    log(f"[h] one step profiled: device busy {busy:.3f} ms of {wall:.3f} ms "
        f"wall ({busy / wall:.1%}; profiler on); by group:")
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"[h]   {ms:9.3f} ms  x{n:<5d} {group} ({ms / busy:.1%})")
    n_copies = groups.get("copies", (0.0, 0))[1]
    log(f"[h] copy kernels in one step's forward + backward: {n_copies} "
        f"launches (want fewer than {LAYERS}: K2 writes the qkv "
        f"projection's gradient as one buffer) "
        f"{'ok' if n_copies < LAYERS else 'FAIL'}")
    if n_copies >= LAYERS:
        raise SystemExit("phase h: the training step still copies per "
                         "layer (the q/k/v gradients scattered back)")
    gemms = [r for r in fb["all"] if any(
        p in r["kernel"] for p in _STEP_GROUPS[2][1])][:6]
    for r in gemms:
        log(f"[h]   GEMM {r['ms']:9.3f} ms  x{r['count']:<4d} "
            f"{r['kernel'][:90]}")
    del net, trainer
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms, "median_step_ms": median,
            "tokens_per_s": tokens_per_s, "k1_launches": k1_total,
            "k1_launches_by_route": k1_by_route, "k2_launches": k2_total,
            "k2_launches_by_route": k2_by_route, "copy_launches": n_copies,
            "profile": {"forward_backward": {k: fb[k] for k in (
                "wall_ms", "device_busy_ms", "launches", "top")},
                "update": {k: upd[k] for k in (
                    "wall_ms", "device_busy_ms", "launches", "top")},
                "groups": {g: {"ms": ms, "launches": n}
                           for g, (ms, n) in groups.items()},
                "gemms": gemms}}


# ------------------------------------------------------------------ phase i
def train_vs_plain(torch, mx, kernels):
    """One training step (loss, backward) of a 2-layer model of the slice's
    widths with K1 + K2 against the same weights with plain attention, in
    fp32 and in bf16: the loss and every parameter's gradient. Gradients
    are compared as max|a - b| / max|b| per parameter, without the key
    third of attn_qkv_bias, whose true gradient is 0 (a bias on every key
    shifts a row's logits by a constant) and which holds rounding noise on
    both sides. fp32 runs K1 and K2 on their 3xTF32 route, bf16 on the
    tensor-core one. Returns {dtype: {"loss": rel err, "grad": worst rel
    err}}.
    """
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    gen = torch.Generator(device="cuda").manual_seed(9)
    nets = {impl: transformer.transformer_lm(
        vocab=VOCAB, units=UNITS, num_heads=HEADS, num_layers=2, max_len=T,
        impl=impl, prefix="tlm_") for impl in ("flash", "dense")}
    nets["flash"].initialize(mx.init.Xavier(), generator=gen)
    nets["dense"].initialize(mx.init.Zero())
    nets["dense"].load_numpy_params(nets["flash"].collect_params())
    x, y = lm_batch(torch, 2, T, VOCAB, seed=1)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def grads(net):
        with mx.autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        out = {n: p.grad().float().clone()
               for n, p in net._param_objects().items()}
        net.zero_grad()
        return loss.item(), out

    def trim(name, g):
        if name.endswith("attn_qkv_bias"):
            return torch.cat([g[:UNITS], g[2 * UNITS:]])
        return g

    errs = {}
    for dtype, route, loss_tol, grad_tol, why in (
            ("float32", "tf32x3", 1e-5, 1e-3, "f32 sums in other orders"),
            ("bfloat16", "tc", 1e-2, 5e-2, "bf16 activations and gradients "
             "(2^-8) rounded at other places; the plain path also rounds "
             "its logits and probabilities")):
        if dtype != "float32":
            for net in nets.values():
                net.cast(dtype)
        zero_counts(kernels)
        l_flash, g_flash = grads(nets["flash"])
        launches = (kernels.flash_attention.launches,
                    kernels.flash_attention_backward.launches)
        on_route = (kernels.flash_attention.launches_by_route[route],
                    kernels.flash_attention_backward.launches_by_route[route])
        l_dense, g_dense = grads(nets["dense"])
        loss_err = abs(l_flash - l_dense) / abs(l_dense)
        worst = max((rel_err(trim(n, g_flash[n]), trim(n, g_dense[n])), n)
                    for n in g_flash)
        ok = (math.isfinite(l_flash) and launches == on_route == (2, 2)
              and loss_err <= loss_tol and worst[0] <= grad_tol)
        log(f"[i] 2-layer {dtype} training step, flash (K1 + K2: "
            f"{launches}, on {route}: {on_route}) vs plain attention: loss "
            f"{l_flash:.5f} vs "
            f"{l_dense:.5f} (rel {loss_err:.2e}, tol {loss_tol:g}); worst "
            f"gradient {worst[0]:.2e} of max|grad| in {worst[1]} (tol "
            f"{grad_tol:g}: {why}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase i: {dtype} training step disagrees")
        errs[dtype] = {"loss": loss_err, "grad": worst[0],
                       "grad_param": worst[1]}
    del nets
    torch.cuda.empty_cache()
    return errs


# ------------------------------------------------------------------ phase j
# train_imagenet.py's recipe: ResNet-50 v1 (NHWC, s2d), SGD lr 0.1,
# momentum 0.9, wd 1e-4, bf16 compute over fp32 masters, batch 256 of
# 3x224x224; 20 steps on one fixed batch, whose loss must fall by 1.0
RESNET_BATCH = 256
RESNET_STEPS = 20
RESNET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
RESNET_LOSS_DROP = 1.0
# microbatches=2 against the fused step on each 128-image half from the
# same state: the same bf16 computation on the same slices, so within one
# bf16 ulp (2^-8) of the loss
RESNET_MB_TOL = 2.0 ** -8
RESNET_GROUPS = (("convolutions (cuDNN)", ("xmma", "conv", "cudnn",
                                           "implicit", "cutlass", "sm90",
                                           "wgrad", "dgrad", "fprop")),
                 ("SGD update (foreach)", ("multi_tensor",)),
                 ("reductions (BN moments, sums)", ("reduce",)),
                 ("copies and dtype casts", _COPY_KERNELS),
                 ("elementwise (BN apply, relu, adds, products)",
                  ("elementwise", "vectorized")),
                 ("max-pool", ("max_pool", "MaxPool")))


def imagenet_batch(torch, n, seed=0):
    """One fixed batch that the recipe can learn: two classes told apart by
    brightness, images uniform in [0, 0.5) for one and [0.5, 1) for the
    other, labels 93 and 812 as float32 (the loss reads them as class
    indices), from a numpy seed; on the card. train_imagenet.py's own
    synthetic batch (uniform images, labels rand * 1000) does not train on
    one fixed batch under this recipe: its loss falls for 3 steps and then
    climbs past where it began, in both packages alike (CPU runs of 20
    steps at 64x64 and 96x96 images, PERF.md)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    cls = rng.randint(0, 2, n)
    x = (0.5 * rng.rand(n, 3, 224, 224)
         + 0.5 * cls[:, None, None, None]).astype(np.float32)
    y = np.where(cls == 1, 812.0, 93.0).astype(np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def clone_trainer(torch, mx, trainer):
    """A second ShardedTrainer over the same net holding a copy of
    ``trainer``'s params, running statistics and momentum."""
    twin = mx.parallel.ShardedTrainer(
        trainer.net, trainer.loss_fn, "sgd", dict(RESNET_OPT),
        dtype="bfloat16")
    with torch.no_grad():
        for src, dst in ((trainer.params, twin.params),
                         (trainer.aux, twin.aux),
                         (trainer.opt_state["state"],
                          twin.opt_state["state"])):
            for k, v in src.items():
                dst[k].copy_(v)
    twin.opt_state["t"] = trainer.opt_state["t"]
    return twin


def resnet_breakdown(rows):
    """{group: (device ms, launches)} of a ResNet step's kernels."""
    out, rest = {}, [0.0, 0]
    for r in rows:
        for group, parts in RESNET_GROUPS:
            if any(p in r["kernel"] for p in parts):
                ms, n = out.get(group, (0.0, 0))
                out[group] = (ms + r["ms"], n + r["count"])
                break
        else:
            rest[0] += r["ms"]
            rest[1] += r["count"]
    out["other"] = tuple(rest)
    return out


def train_resnet(torch, mx):
    """ResNet-50 v1 (NHWC, s2d stem, 1000 classes) at full depth and width
    trained by parallel.ShardedTrainer on one card: Xavier(gaussian, in, 2)
    weights from a seeded generator, fp32 masters, bf16 compute, SGD
    momentum with wd, 20 steps on one fixed batch of 256 images. Gates:
    a microbatches=2 step from a copy of the initial state equal to the
    fused step on each half, finite losses, the last at least 1.0 below
    the first, fp32 masters, momentum and running statistics, the running
    statistics moved, and a predict-mode forward after sync_to_net with
    finite (32, 1000) logits.
    """
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon.model_zoo import vision

    gen = torch.Generator(device="cuda").manual_seed(0)
    net = vision.resnet50_v1(layout="NHWC", stem="s2d", classes=1000)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), generator=gen)
    trainer = mx.parallel.ShardedTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        dict(RESNET_OPT), dtype="bfloat16")         # default mesh: gpu(0)
    aux0 = {k: v.clone() for k, v in trainer.aux.items()}
    x, y = imagenet_batch(torch, RESNET_BATCH)
    n_params = sum(v.numel() for v in trainer.params.values())
    log(f"[j] resnet50_v1 NHWC s2d: {n_params} trainable parameters "
        f"({len(trainer.params)} tensors), {len(trainer.aux)} running "
        f"statistics; batch {tuple(x.shape)}, mesh {trainer.mesh}")

    half = RESNET_BATCH // 2

    def twin_step(*args, **kwargs):
        # one at a time: each twin captures its own step's graph
        twin = clone_trainer(torch, mx, trainer)
        loss = twin.step(*args, **kwargs).item()
        del twin
        torch.cuda.empty_cache()
        return loss

    mb = twin_step(x, y, microbatches=2)
    halves = [twin_step(x[:half], y[:half]), twin_step(x[half:], y[half:])]
    fused = twin_step(x, y)
    want = sum(halves) / 2
    mb_err = abs(mb - want) / abs(want)
    ok = math.isfinite(mb) and mb_err <= RESNET_MB_TOL
    log(f"[j] microbatches=2 step from a copy of the initial state: loss "
        f"{mb:.5f}; the fused step on each {half}-image half: "
        f"{halves[0]:.5f}, "
        f"{halves[1]:.5f} (mean {want:.5f}, rel {mb_err:.2e}, tol "
        f"{RESNET_MB_TOL:.2e}: one bf16 ulp) {'ok' if ok else 'FAIL'}; the "
        f"fused {RESNET_BATCH}-image step: {fused:.5f} (rel "
        f"{abs(mb - fused) / fused:.2e}; BatchNorm's statistics there are "
        f"over {RESNET_BATCH} images, not {half})")
    if not ok:
        raise SystemExit("phase j: microbatches=2 disagrees with the fused "
                         "step")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer.step(x, y))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    losses = [v.item() for v in losses]
    for i in range(0, RESNET_STEPS, 4):
        log(f"[j] steps {i + 1}-{min(i + 4, RESNET_STEPS)}: loss "
            + ", ".join(f"{v:.4f}" for v in losses[i:i + 4]) + "; ms "
            + ", ".join(f"{v:.2f}" for v in step_ms[i:i + 4]))
    timed = sorted(step_ms[1:])
    median = timed[len(timed) // 2]
    images_per_s = RESNET_BATCH / (median / 1e3)
    drop = losses[0] - losses[-1]
    fp32 = all(v.dtype == torch.float32 for v in trainer.params.values()) \
        and all(v.dtype == torch.float32
                for v in trainer.opt_state["state"].values()) \
        and all(v.dtype == torch.float32 for v in trainer.aux.values())
    moved = sum(not torch.equal(v, aux0[k]) for k, v in trainer.aux.items())
    ok = (all(math.isfinite(v) for v in losses)
          and drop >= RESNET_LOSS_DROP and fp32 and moved == len(aux0))
    log(f"[j] {RESNET_STEPS} steps: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (drop {drop:.4f}, want >= {RESNET_LOSS_DROP}); "
        f"masters, momentum and running statistics fp32: {fp32}; running "
        f"statistics moved: {moved} of {len(aux0)}; median step "
        f"{median:.2f} ms over steps 2-{RESNET_STEPS} (host clock, "
        f"profiler off), {images_per_s:.1f} images/s; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase j: the ResNet-50 training step failed its "
                         "checks")

    step = profile_window(torch, lambda: trainer.step(x, y),
                          "one ResNet-50 training step", "j",
                          ("xmma", "conv", "cudnn"), top=12)
    _, grads, _ = trainer._loss_and_grads(x, y)
    torch.cuda.synchronize()
    upd = profile_window(torch, lambda: trainer._update(
        trainer.params, grads, trainer.opt_state),
        "the SGD update alone", "j", ("multi_tensor",))
    del grads
    groups = resnet_breakdown(step["all"])
    log(f"[j] one step profiled: device busy {step['device_busy_ms']:.3f} "
        f"ms of {step['wall_ms']:.3f} ms wall "
        f"({step['device_busy_ms'] / step['wall_ms']:.1%}; profiler on), "
        f"{step['launches']} launches; the SGD update alone: "
        f"{upd['launches']} launches, {upd['device_busy_ms']:.3f} ms "
        f"device; by group:")
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"[j]   {ms:9.3f} ms  x{n:<5d} {group} "
            f"({ms / step['device_busy_ms']:.1%})")

    trainer.sync_to_net()
    pred = serving.Predictor.from_block(
        net, input_shapes={"data": (3, 224, 224)}, batch_sizes=(32,))
    logits = pred.predict(x[:32])[0]
    top1 = mx.metric.Accuracy()
    top1.update(y[:32], logits)
    ok = tuple(logits.shape) == (32, 1000) and bool(
        torch.isfinite(logits).all())
    log(f"[j] sync_to_net, then Predictor (predict mode, running "
        f"statistics): logits {tuple(logits.shape)} {logits.dtype}, finite "
        f"{bool(torch.isfinite(logits).all())}, train top-1 on 32 of the "
        f"batch's images {top1.get()[1]:.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase j: the synced net's logits are wrong")
    del pred, net, trainer, x, y
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms, "median_step_ms": median,
            "images_per_s": images_per_s, "max_memory_allocated": peak,
            "microbatch_loss": mb, "half_losses": halves,
            "fused_loss": fused, "microbatch_rel_err": mb_err,
            "top1": top1.get()[1],
            "profile": {"step": {k: step[k] for k in (
                "wall_ms", "device_busy_ms", "launches", "top")},
                "update": {k: upd[k] for k in (
                    "wall_ms", "device_busy_ms", "launches", "top")},
                "groups": {g: {"ms": ms, "launches": n}
                           for g, (ms, n) in groups.items()}}}


# ------------------------------------------------------------------ phase k
# ResNet-50's stride-1 3x3 convs per shape (stages 1-4: 3, 4, 6, 3 blocks)
RESNET_3X3_COUNTS = (3, 4, 6, 3)
# K3's trainable wrapper and the model's unfused path, both bf16, are each
# held to the unfused path in f32 on the same (bf16-valued) inputs, as
# ||a - b|| / ||b||. K3 must lie within K3_TRAIN_TOL of it: both round y,
# the output and every gradient term to bf16 (2^-8), and relu's mask flips
# where bf16 and f32 disagree on the sign, so each lies ~4e-3 from f32 in
# its output and ~3e-2 in its gradients (CPU runs of the plain version at
# small shapes); K3 takes its statistics from the f32 accumulator. And it
# must be no less accurate than the unfused path: within K3_VS_F32_FACTOR
# times that path's own error plus 1e-3. K3 against the unfused path is
# printed, not gated: at 56x56x64, N=256 the unfused path's dw lies 0.21
# from f32 (its BatchNorm backward sums bf16 terms before the weight
# gradient's 802816-long reduction), K3's 0.039 (its dy is formed in f32
# and rounded once).
K3_VS_F32_FACTOR = 2.0
K3_TRAIN_TOL = {"out": 1e-2, "mean": 1e-3, "var": 1e-3, "dx": 1e-1,
                "dw": 1e-1, "dgamma": 1e-1, "dbeta": 1e-1}
RESNET_BN_EPS = 1e-5


def k3_train_inputs(torch, gen, n, hw, c, dtype=None):
    """The model's tensors at one 3x3 conv: a relu'd activation, He-scaled
    HWIO weights, gamma and beta, and a seeded cotangent, in ``dtype`` (by
    default bf16: ShardedTrainer's bf16 casts)."""
    dtype = dtype or torch.bfloat16
    x = torch.relu(torch.randn((n, hw, hw, c), generator=gen,
                               device="cuda")).to(dtype)
    w = (torch.randn((3, 3, c, c), generator=gen, device="cuda")
         * math.sqrt(2.0 / (9 * c))).to(dtype)
    gamma = (torch.rand(c, generator=gen, device="cuda") + 0.5).to(dtype)
    beta = (torch.randn(c, generator=gen, device="cuda") * 0.1).to(dtype)
    dout = torch.randn((n, hw, hw, c), generator=gen, device="cuda").to(
        dtype)
    return x, w, gamma, beta, dout


def unfused_conv_bn_relu(torch, x, w_ohwi, gamma, beta):
    """The path the model runs: ops.nn.convolution (cuDNN, NHWC), then
    ops.nn.batch_norm in training, then relu. Returns (out, mean, var):
    with zero moving statistics and momentum 0 its new moving statistics
    are the batch's own."""
    from mxnet_tpu_torch.ops import nn as ops_nn

    c = w_ohwi.shape[0]
    y = ops_nn.convolution(x, w_ohwi, kernel=(3, 3), pad=(1, 1),
                           num_filter=c, no_bias=True, layout="NHWC")
    zeros = torch.zeros(c, device=x.device)
    out, mean, var = ops_nn.batch_norm(
        y, gamma, beta, zeros, zeros, eps=RESNET_BN_EPS, momentum=0.0,
        fix_gamma=False, axis=3, _train=True)
    return torch.relu(out), mean, var


def k3_at_training_shapes(torch, kernels, n, step_ms=None, shapes=None):
    """K3's trainable wrapper (ops/kernels.conv3x3_bn_relu_train) against
    the unfused path at ResNet-50's four stride-1 3x3 shapes at phase j's
    batch, bf16: outputs, batch statistics and gradients within
    K3_TRAIN_TOL of the f32 reference and no further from it than the
    unfused path, every K3 launch on the tensor-core route, and both
    timed (device_ms) forward and forward + backward. The difference,
    weighted by the 16 convs, is set against phase j's step ``step_ms``
    when given. ``shapes``: [((H, C), convs of that shape)], by default
    ResNet-50's four."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = []
    for (hw, c), count in shapes or zip(RESNET_3X3, RESNET_3X3_COUNTS):
        x, w, gamma, beta, dout = k3_train_inputs(torch, gen, n, hw, c)
        w_ohwi = w.permute(3, 0, 1, 2).contiguous()
        k3_leaves = leaves_of(x, w, gamma, beta)
        plain_leaves = leaves_of(x, w_ohwi, gamma, beta)

        def k3_fwd():
            return kernels.conv3x3_bn_relu_train(*k3_leaves,
                                                 eps=RESNET_BN_EPS)

        def plain_fwd():
            return unfused_conv_bn_relu(torch, *plain_leaves)

        zero_counts(kernels)
        k3 = k3_values(torch, kernels, k3_leaves, dout)
        torch.cuda.synchronize()
        launches = dict(kernels.conv3x3_bn_stats.launches_by_route)
        un = unfused_values(torch, plain_leaves, dout)
        f32 = unfused_values(torch, leaves_of(*(t.float() for t in (
            x, w_ohwi, gamma, beta))), dout.float())
        names = ("out", "mean", "var", "dx", "dw", "dgamma", "dbeta")
        errs = {k: l2_err(a, b) for k, a, b in zip(names, k3, un)}
        k3_f32 = {k: l2_err(a, b) for k, a, b in zip(names, k3, f32)}
        un_f32 = {k: l2_err(a, b) for k, a, b in zip(names, un, f32)}
        del un, f32
        ok = launches == {"tc": 1, "tf32x3": 0, "simt": 0} and all(
            k3_f32[k] <= min(tol, K3_VS_F32_FACTOR * un_f32[k] + 1e-3)
            for k, tol in K3_TRAIN_TOL.items())
        log(f"[k] conv3x3_bn_relu_train bf16 ({n}, {hw}, {hw}, {c}) x "
            f"{count}: ||a - f32|| / ||f32||, K3 / unfused: "
            + ", ".join(f"{k} {k3_f32[k]:.2e} / {un_f32[k]:.2e}"
                        for k in names)
            + f" (K3 within {K3_TRAIN_TOL} and within "
            f"{K3_VS_F32_FACTOR:g}x the unfused path's + 1e-3); "
            "||K3 - unfused|| / ||unfused||: "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f"; K3 launches {launches} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("phase k: K3's trainable wrapper strays from "
                             "f32 beyond its tolerance or the unfused "
                             "path's error, or left the tensor-core route")
        with torch.no_grad():
            k3_ms = device_ms(k3_fwd, n=10)
            plain_ms = device_ms(plain_fwd, n=10)
            # K3's plain version, the wrapper's conv + statistics
            ref_ms = device_ms(
                lambda: kernels.conv3x3_bn_stats_reference(x, w), n=3)
        k3_fb_ms = device_ms(lambda: k3_values(torch, kernels, k3_leaves,
                                               dout), n=5)
        plain_fb_ms = device_ms(lambda: unfused_values(torch, plain_leaves,
                                                       dout), n=5)
        flops, nbytes = conv_work(n, hw, hw, c, c, 2)
        bound_ms, bound_by = bound(flops, nbytes)
        by_route = dict(kernels.conv3x3_bn_stats.launches_by_route)
        if by_route["simt"] or by_route["tf32x3"]:
            raise SystemExit("phase k: a K3 launch left the tensor-core "
                             "route")
        log(f"[k]   forward: K3 {k3_ms:.4f} ms, unfused {plain_ms:.4f} ms "
            f"(K3 / unfused {k3_ms / plain_ms:.2f}x; K3's conv + statistics "
            f"bound {bound_ms:.4f} ms by {bound_by}, its plain version "
            f"{ref_ms:.4f} ms); forward + backward: "
            f"K3 {k3_fb_ms:.4f} ms, unfused {plain_fb_ms:.4f} ms "
            f"({k3_fb_ms / plain_fb_ms:.2f}x); K3 launches {by_route}")
        rows.append({"shape": [n, hw, hw, c, c], "count": count,
                     "errs": errs, "k3_vs_f32": k3_f32,
                     "unfused_vs_f32": un_f32, "fwd_ms": k3_ms,
                     "unfused_fwd_ms": plain_ms, "plain_k3_ms": ref_ms,
                     "fwd_bwd_ms": k3_fb_ms,
                     "unfused_fwd_bwd_ms": plain_fb_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "launches_by_route": by_route})
        del x, w, w_ohwi, gamma, beta, dout, k3_leaves, plain_leaves, k3
    fwd = sum(r["count"] * (r["unfused_fwd_ms"] - r["fwd_ms"])
              for r in rows)
    fwd_bwd = sum(r["count"] * (r["unfused_fwd_bwd_ms"] - r["fwd_bwd_ms"])
                  for r in rows)
    n_convs = sum(r["count"] for r in rows)
    for what, saved in (("forward", fwd), ("forward + backward", fwd_bwd)):
        share = (f" of phase j's {step_ms:.2f} ms step "
                 f"({abs(saved) / step_ms:.2%})" if step_ms else "")
        log(f"[k] weighted by the {n_convs} convs, {what}: K3 would "
            f"{'save' if saved >= 0 else 'cost'} {abs(saved):.3f} ms{share}")
    torch.cuda.empty_cache()
    return {"per_shape": rows, "saved_fwd_ms": fwd,
            "saved_fwd_bwd_ms": fwd_bwd, "step_ms": step_ms,
            "launches": sum(sum(r["launches_by_route"].values())
                            for r in rows)}


# K3's trainable wrapper in fp32 against the fp32 unfused path, ||a - b|| /
# ||b||: both compute in f32 (K3 as 3xTF32, within ~1e-6 of max|y|; cuDNN
# with TF32 off), and their outputs and statistics agree to ~1e-6, but
# relu's mask flips wherever the two pre-activations straddle 0 by that
# much: over the 6-51 M elements of a shape at N=256 such flips moved dx,
# dw and dbeta by up to 7.6e-4 on the H100. A wrong kernel or statistic
# moves them by orders of magnitude more.
K3_FP32_TRAIN_TOL = 1e-2


def k3_fp32_at_training_shapes(torch, kernels, n, step_ms=None):
    """Phase k in fp32, a measurement: K3's trainable wrapper on the 3xTF32
    route against the fp32 unfused path (cuDNN conv with TF32 off,
    batch_norm in training, relu; backward by autograd) at ResNet-50's four
    stride-1 3x3 shapes at phase j's batch. Every K3 launch on "tf32x3" and
    the seven values (out, mean, var, dx, dw, dgamma, dbeta) within
    K3_FP32_TRAIN_TOL of the unfused path's are checked; forward and
    forward + backward are timed (device_ms) and the difference, weighted
    by the 16 convs, printed beside phase j's bf16 step ``step_ms``. K3
    stays off ShardedTrainer's path, as in mxnet_tpu."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    names = ("out", "mean", "var", "dx", "dw", "dgamma", "dbeta")
    rows = []
    for (hw, c), count in zip(RESNET_3X3, RESNET_3X3_COUNTS):
        x, w, gamma, beta, dout = k3_train_inputs(torch, gen, n, hw, c,
                                                  torch.float32)
        w_ohwi = w.permute(3, 0, 1, 2).contiguous()
        k3_leaves = leaves_of(x, w, gamma, beta)
        plain_leaves = leaves_of(x, w_ohwi, gamma, beta)
        zero_counts(kernels)
        k3 = k3_values(torch, kernels, k3_leaves, dout)
        torch.cuda.synchronize()
        launches = dict(kernels.conv3x3_bn_stats.launches_by_route)
        un = unfused_values(torch, plain_leaves, dout)
        errs = {k: l2_err(a, b) for k, a, b in zip(names, k3, un)}
        del k3, un
        ok = launches == {"tc": 0, "tf32x3": 1, "simt": 0} and all(
            e <= K3_FP32_TRAIN_TOL for e in errs.values())
        log(f"[k] conv3x3_bn_relu_train fp32 ({n}, {hw}, {hw}, {c}) x "
            f"{count}: ||K3 - unfused|| / ||unfused|| "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f" (tol {K3_FP32_TRAIN_TOL:g}: both f32, relu's mask flips "
            "where they straddle 0); K3 launches "
            f"{launches} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("phase k: K3's fp32 trainable wrapper strays "
                             "from the fp32 unfused path or left the 3xTF32 "
                             "route")
        with torch.no_grad():
            k3_ms = device_ms(lambda: kernels.conv3x3_bn_relu_train(
                *k3_leaves, eps=RESNET_BN_EPS), n=10)
            plain_ms = device_ms(lambda: unfused_conv_bn_relu(
                torch, *plain_leaves), n=10)
            ref_ms = device_ms(
                lambda: kernels.conv3x3_bn_stats_reference(x, w), n=3)
        k3_fb_ms = device_ms(lambda: k3_values(torch, kernels, k3_leaves,
                                               dout), n=5)
        plain_fb_ms = device_ms(lambda: unfused_values(torch, plain_leaves,
                                                       dout), n=5)
        by_route = dict(kernels.conv3x3_bn_stats.launches_by_route)
        if by_route["tc"] or by_route["simt"]:
            raise SystemExit("phase k: an fp32 K3 launch left the 3xTF32 "
                             "route")
        flops, nbytes = conv_work(n, hw, hw, c, c, 4)
        bound_ms, bound_by, _ = bound_tf32x3(flops, nbytes)
        log(f"[k]   fp32 forward: K3 {k3_ms:.4f} ms, unfused {plain_ms:.4f} "
            f"ms (K3 / unfused {k3_ms / plain_ms:.2f}x; K3's conv + "
            f"statistics 3xTF32 bound {bound_ms:.4f} ms by {bound_by}, its "
            f"plain version {ref_ms:.4f} ms); "
            f"forward + backward: K3 {k3_fb_ms:.4f} ms, unfused "
            f"{plain_fb_ms:.4f} ms ({k3_fb_ms / plain_fb_ms:.2f}x); K3 "
            f"launches {by_route}")
        rows.append({"shape": [n, hw, hw, c, c], "count": count,
                     "errs": errs, "fwd_ms": k3_ms, "unfused_fwd_ms": plain_ms,
                     "plain_k3_ms": ref_ms,
                     "fwd_bwd_ms": k3_fb_ms,
                     "unfused_fwd_bwd_ms": plain_fb_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "launches_by_route": by_route})
        del x, w, w_ohwi, gamma, beta, dout, k3_leaves, plain_leaves
    fwd = sum(r["count"] * (r["unfused_fwd_ms"] - r["fwd_ms"])
              for r in rows)
    fwd_bwd = sum(r["count"] * (r["unfused_fwd_bwd_ms"] - r["fwd_bwd_ms"])
                  for r in rows)
    n_convs = sum(r["count"] for r in rows)
    for what, saved in (("forward", fwd), ("forward + backward", fwd_bwd)):
        share = (f" (phase j's bf16 step is {step_ms:.2f} ms)" if step_ms
                 else "")
        log(f"[k] fp32, weighted by the {n_convs} convs, {what}: K3 would "
            f"{'save' if saved >= 0 else 'cost'} {abs(saved):.3f} ms{share}")
    torch.cuda.empty_cache()
    return {"per_shape": rows, "saved_fwd_ms": fwd,
            "saved_fwd_bwd_ms": fwd_bwd,
            "launches": sum(sum(r["launches_by_route"].values())
                            for r in rows)}


def l2_err(a, b):
    """||a - b|| / ||b|| in f32 (0 when both are all zero)."""
    a, b = a.float(), b.float()
    scale = b.norm().item()
    err = (a - b).norm().item()
    return err / scale if scale else err


def leaves_of(*tensors):
    """Copies of ``tensors`` that require grad."""
    return [t.detach().clone().requires_grad_(True) for t in tensors]


def k3_values(torch, kernels, leaves, dout):
    """(out, mean, var, dx, dw (OHWI), dgamma, dbeta) of K3's trainable
    wrapper on ``leaves`` = (x, w HWIO, gamma, beta) and cotangent
    ``dout``, in one forward and one backward."""
    out = kernels.conv3x3_bn_relu_train(*leaves, eps=RESNET_BN_EPS)
    dx, dw, dg, db = torch.autograd.grad(out[0], leaves, dout)
    return [t.detach() for t in out] + [dx, dw.permute(3, 0, 1, 2), dg, db]


def unfused_values(torch, leaves, dout):
    """The same seven values through the unfused path on ``leaves`` = (x,
    w OHWI, gamma, beta)."""
    out = unfused_conv_bn_relu(torch, *leaves)
    grads = torch.autograd.grad(out[0], leaves, dout)
    return [t.detach() for t in out] + list(grads)


# ------------------------------------------------------------------ phase l
CAPTURE_LM_STEPS = 10
CAPTURE_RESNET_STEPS = 6
CAPTURE_PREDICTS = 20
GRAPH_DIR = []      # where graphs' DOT dumps are kept (--summary's dir)


_DOT_NODE = re.compile(r'(?m)^\s*(?="graph_\d+_node_\d+"\s*\[)')


def graph_nodes(ex, name, parts=(), sig=None):
    """{"kernels": kernel nodes, part: kernel nodes whose function name
    holds part} of a graph of ``ex`` (its last, or ``sig``'s), from its DOT
    dump, which is kept gzipped in GRAPH_DIR when --summary gives one."""
    import gzip
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{name}.dot")
        ex.debug_dump(sig if sig is not None else ex.last_entry.sig, path)
        with open(path) as f:
            text = f.read()
    if GRAPH_DIR:
        os.makedirs(GRAPH_DIR[0], exist_ok=True)
        with gzip.open(os.path.join(GRAPH_DIR[0], f"{name}.dot.gz"),
                       "wt") as f:
            f.write(text)
    nodes = [c for c in _DOT_NODE.split(text)[1:]
             if "KERNEL" in c or "Kernel" in c]
    if not nodes:
        raise SystemExit(f"phase l: no kernel node found in {name}'s DOT "
                         f"dump (starts: {text[:600]!r})")
    out = {"kernels": len(nodes)}
    for p in parts:
        out[p] = sum(p in c for c in nodes)
    return out


def capture_kernels_alone(torch, kernels, capture):
    """Each route of K1, K2 and K3 captured alone in a graph, then replayed
    on new inputs copied into its static buffers: each replay bitwise equal
    to an eager launch on those inputs, on the route it names (fp32 D=64
    and fp32 convs of 64 channels take "tf32x3", whose graphs must hold one
    kernel node for K1, three for K2 and three for K3 (the weight
    pre-pass, the conv, the statistics' reduction); fp32 D=80 and fp32
    convs of 60 channels the CUDA cores)."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    bf16, f32 = torch.bfloat16, torch.float32

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def attn(dtype, d=64):
        return [rnd((2, 4, 256, d), dtype) for _ in range(3)]

    def bwd_inputs(dtype, d=64):
        q, k, v = attn(dtype, d)
        out, lse = kernels.flash_attention(q, k, v, causal=True,
                                           return_lse=True)
        return [q, k, v, out, lse, rnd(q.shape, dtype)]

    def conv(dtype, c=64):
        return [rnd((4, 16, 16, c), dtype), rnd((3, 3, c, c), dtype, 0.05)]

    def k1(q, k, v):
        return list(kernels.flash_attention(q, k, v, causal=True,
                                            return_lse=True))

    def k2(q, k, v, o, lse, dout):
        return list(kernels.flash_attention_backward(q, k, v, o, lse, dout,
                                                     causal=True))

    def k3(x, w):
        return list(kernels.conv3x3_bn_stats(x, w))

    cases = []
    for route, dtype, d, c in (("tc", bf16, 64, 64), ("tf32x3", f32, 64, 64),
                               ("simt", f32, 80, 60)):
        cases += [("K1", route, kernels.flash_attention, k1,
                   attn(dtype, d), attn(dtype, d), 1),
                  ("K2", route, kernels.flash_attention_backward, k2,
                   bwd_inputs(dtype, d), bwd_inputs(dtype, d), 3),
                  ("K3", route, kernels.conv3x3_bn_stats, k3,
                   conv(dtype, c), conv(dtype, c), 3)]
    records = []
    for name, route, wrapper, fn, first, second, want_nodes in cases:
        ex = capture.CapturedExec(fn, label=f"{name} {route} alone",
                                  device="cuda")
        before = wrapper.launches_by_route[route]
        ex(*first)
        enqueued = wrapper.launches_by_route[route] - before
        got = ex(*second)
        replays = wrapper.launches_by_route[route] - before - enqueued
        want = fn(*second)
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        nodes = graph_nodes(ex, f"{name}_{route}_alone")
        ok = same and enqueued == 3 and replays == 0 and (
            route != "tf32x3" or nodes["kernels"] == want_nodes)
        log(f"[l] {name} ({route}) captured alone: replay on new inputs "
            f"== eager launch bitwise: {same}; wrapper launches at warm-up "
            f"+ capture {enqueued} (want 3), at a replay {replays} (want 0); "
            f"graph kernel nodes {nodes['kernels']}"
            f"{f' (want {want_nodes})' if route == 'tf32x3' else ''} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase l: {name} ({route}) replayed from a "
                             "graph differs from its eager launch")
        records.append({"kernel": name, "route": route, "bitwise": same,
                        "nodes": nodes["kernels"]})
    return records


def max_abs_diff(torch, a, b):
    """max |a - b| over two {name: tensor} dicts, in f32."""
    return max((a[k].float() - b[k].float()).abs().max().item() for k in a)


def equal_dicts(torch, a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def judge(torch, label, eager, eager2, captured):
    """The card check of a captured path against eager (each a dict of
    tensors from one start): bitwise when eager repeats itself bitwise,
    else within eager's own run-to-run spread. Returns the verdict."""
    repeats = equal_dicts(torch, eager, eager2)
    same = equal_dicts(torch, eager, captured)
    spread = 0.0 if repeats else max_abs_diff(torch, eager, eager2)
    diff = 0.0 if same else max_abs_diff(torch, eager, captured)
    ok = same if repeats else diff <= spread
    case = ("eager repeats bitwise, so captured must equal it bitwise"
            if repeats else "eager does not repeat bitwise (spread "
            f"{spread:.3e}), so captured may differ by no more")
    log(f"[l] {label}: {case}; captured == eager bitwise: {same} (max "
        f"|diff| {diff:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"phase l: the captured {label} disagrees with "
                         "eager")
    return {"eager_repeats_bitwise": repeats, "bitwise": same,
            "eager_spread": spread, "max_abs_diff": diff}


class kill_switch:
    """MXNET_TPU_TORCH_CAPTURE=0 inside the block: the eager path."""

    def __enter__(self):
        self._old = os.environ.get("MXNET_TPU_TORCH_CAPTURE")
        os.environ["MXNET_TPU_TORCH_CAPTURE"] = "0"

    def __exit__(self, *exc):
        if self._old is None:
            del os.environ["MXNET_TPU_TORCH_CAPTURE"]
        else:
            os.environ["MXNET_TPU_TORCH_CAPTURE"] = self._old


def step_run(torch, capture, mode, make_step, n_steps, label, groups):
    """``n_steps`` steps of ``make_step()`` (returns (step(), state(),
    exec or None)) on one path: losses, host-clock ms, peak memory, the
    state after the steps, one more step profiled, the capture counters."""
    scope = kill_switch() if mode == "eager" else contextlib.nullcontext()
    with scope:
        step, state, ex = make_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for i in range(n_steps):
            if i == 1:
                capture.reset_stats()    # after warm-up and capture
                capture.clear_retrace_log()
            t0 = time.perf_counter()
            losses.append(step())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counters = capture.stats()
        retraces = capture.retrace_log()
        peak = torch.cuda.max_memory_allocated()
        after = {k: v.detach().clone() for k, v in state().items()}
        after.update({f"loss{i}": v.detach().reshape(1)
                      for i, v in enumerate(losses)})
        prof = profile_window(torch, step, f"one {mode} {label}", "l",
                              groups, top=4)
    timed = sorted(ms[1:])
    rec = {"step_ms": ms, "median_ms": timed[len(timed) // 2],
           "peak_bytes": peak, "busy_ms": prof["device_busy_ms"],
           "wall_ms": prof["wall_ms"], "launches": prof["launches"],
           "counters": counters,
           "capture_s": (ex.last_entry.capture_s if mode == "captured"
                         else None),
           "retraces": retraces, "losses": [v.item() for v in losses]}
    if mode == "captured" and (counters["capture_retraces"]
                               or counters["capture_fallback_eager"]):
        raise SystemExit(f"phase l: {label} retraced or ran eagerly after "
                         f"warm-up: {counters} {retraces}")
    return rec, after, ex


def capture_lm_step(torch, mx, kernels, capture):
    """Phase h's LM step (bf16, B=8, T=1024, Adam lr 1e-3) through
    capture.capture(trainer, net=, loss_fn=) and through the kill switch,
    each CAPTURE_LM_STEPS steps from one start (eager twice)."""
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    def net_of(values=None):
        net = transformer.transformer_lm(
            vocab=VOCAB, units=UNITS, num_heads=HEADS, num_layers=LAYERS,
            max_len=T, impl="flash", prefix="tlm_")
        if values is None:
            net.initialize(mx.init.Xavier(), generator=torch.Generator(
                device="cuda").manual_seed(0))
        else:
            net.initialize(mx.init.Zero())
        net.cast("bfloat16")
        if values is not None:
            for k, p in net._param_objects().items():
                p.set_data(values[k])
        return net

    values = {k: v.detach().clone()
              for k, v in net_of().collect_params().items()}
    x, y = lm_batch(torch, BATCH, T, VOCAB)
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def lm_loss(out, label):
        return ce(out, label).mean()

    def make_step():
        net = net_of(values)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": LR})
        step = capture.capture(trainer, net=net, loss_fn=lm_loss)
        return ((lambda: step(x, y, batch_size=1)),
                (lambda: dict(net.collect_params())), step._exec)

    groups = ("flash_fwd", "flash_bwd")
    runs, afters = {}, {}
    for mode in ("eager", "eager2", "captured"):
        rec, after, ex = step_run(torch, capture, mode.rstrip("2"),
                                  make_step, CAPTURE_LM_STEPS, "LM step",
                                  groups)
        runs[mode], afters[mode] = rec, after
        if mode == "captured":
            nodes = graph_nodes(ex, "lm_step", (
                "flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel",
                "flash_bwd_dq_tc_kernel"))
        del after
        torch.cuda.empty_cache()
    verdict = judge(torch, f"LM step ({CAPTURE_LM_STEPS} steps: losses and "
                    "every weight)",
                    afters["eager"], afters["eager2"], afters["captured"])
    del afters
    torch.cuda.empty_cache()
    k1, k2 = nodes["flash_fwd_tc_kernel"], nodes["flash_bwd_dkdv_tc_kernel"]
    ok = k1 == LAYERS and k2 == LAYERS and \
        nodes["flash_bwd_dq_tc_kernel"] == LAYERS
    for mode in ("eager", "captured"):
        r = runs[mode]
        log(f"[l] LM step {mode}: median {r['median_ms']:.2f} ms (steps "
            f"2-{CAPTURE_LM_STEPS}, host clock), "
            f"{BATCH * T / (r['median_ms'] / 1e3):.1f} tokens/s; one step "
            f"profiled: busy {r['busy_ms']:.3f} ms of {r['wall_ms']:.3f} ms "
            f"wall, {r['launches']} kernels; peak memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB"
            + (f"; capture {r['capture_s']:.2f} s" if r["capture_s"]
               else ""))
    log(f"[l] LM step graph: {nodes['kernels']} kernel nodes, K1 "
        f"(flash_fwd_tc) {k1}, K2 (dk/dv, dq) {k2}, "
        f"{nodes['flash_bwd_dq_tc_kernel']} (want {LAYERS} each) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase l: the LM step graph does not hold 12 K1 "
                         "and 12 K2 nodes")
    return {"runs": runs, "nodes": nodes, "verdict": verdict}


def capture_resnet_step(torch, mx, capture):
    """Phase j's ResNet-50 step (ShardedTrainer, bf16 over fp32 masters,
    SGD, batch 256) captured and through the kill switch, each
    CAPTURE_RESNET_STEPS steps from one start (eager twice)."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    x, y = imagenet_batch(torch, RESNET_BATCH)

    def make_step():
        net = vision.resnet50_v1(layout="NHWC", stem="s2d", classes=1000,
                                 prefix="r50_")
        net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                      magnitude=2),
                       generator=torch.Generator(device="cuda").manual_seed(0))
        trainer = mx.parallel.ShardedTrainer(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            dict(RESNET_OPT), dtype="bfloat16")

        def state():
            out = {f"p:{k}": v for k, v in trainer.params.items()}
            out.update({f"a:{k}": v for k, v in trainer.aux.items()})
            out.update({f"m:{k}": v for k, v in
                        trainer.opt_state["state"].items()})
            return out

        return (lambda: trainer.step(x, y)), state, trainer._exec

    groups = ("xmma", "conv", "cudnn")
    runs, afters = {}, {}
    for mode in ("eager", "eager2", "captured"):
        rec, after, ex = step_run(torch, capture, mode.rstrip("2"),
                                  make_step, CAPTURE_RESNET_STEPS,
                                  "ResNet-50 step", groups)
        runs[mode], afters[mode] = rec, after
        if mode == "captured":
            nodes = graph_nodes(ex, "resnet_step")
        del after
        torch.cuda.empty_cache()
    verdict = judge(torch, f"ResNet-50 step ({CAPTURE_RESNET_STEPS} steps: "
                    "losses, masters, running statistics, momentum)",
                    afters["eager"],
                    afters["eager2"], afters["captured"])
    del afters
    torch.cuda.empty_cache()
    for mode in ("eager", "captured"):
        r = runs[mode]
        log(f"[l] ResNet-50 step {mode}: median {r['median_ms']:.2f} ms "
            f"(steps 2-{CAPTURE_RESNET_STEPS}, host clock), "
            f"{RESNET_BATCH / (r['median_ms'] / 1e3):.1f} images/s; one "
            f"step profiled: busy {r['busy_ms']:.3f} ms of "
            f"{r['wall_ms']:.3f} ms wall, {r['launches']} kernels; peak "
            f"memory {r['peak_bytes'] / 2**30:.2f} GiB"
            + (f"; capture {r['capture_s']:.2f} s" if r["capture_s"]
               else ""))
    log(f"[l] ResNet-50 step graph: {nodes['kernels']} kernel nodes")
    return {"runs": runs, "nodes": nodes, "verdict": verdict}


def serve_both(torch, capture, serving, pred, batch, requests, max_batch,
               label, groups, node_parts=()):
    """One predictor served captured and through the kill switch: a
    bucket predict bitwise against eager (eager twice), p50 of
    CAPTURE_PREDICTS predicts on the host clock, one profiled, and the
    BatchServer's requests/s for 4 threads of ``requests``."""
    out = {}
    outs = {}
    for mode in ("captured", "eager", "eager2"):
        scope = kill_switch() if mode != "captured" else \
            contextlib.nullcontext()
        with scope:
            capture.reset_stats()
            capture.clear_retrace_log()
            outs[mode] = pred.predict(batch)[0]
            if mode == "eager2":
                continue
            ms = []
            for _ in range(CAPTURE_PREDICTS):
                t0 = time.perf_counter()
                pred.predict(batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            prof = profile_window(torch, lambda: pred.predict(batch),
                                  f"one {mode} {label} predict", "l",
                                  groups, top=3)
            results = []
            with serving.BatchServer(pred, max_batch_size=max_batch,
                                     batch_timeout_ms=5.0) as server:
                def client(reqs):
                    futs = [server.submit(r) for r in reqs]
                    results.extend(f.result(timeout=600) for f in futs)

                threads = [threading.Thread(target=client, args=(r,))
                           for r in requests]
                t0 = time.perf_counter()
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(600)
                wall = time.perf_counter() - t0
            n_req = sum(len(r) for r in requests)
            if any(th.is_alive() for th in threads) or len(results) != n_req:
                raise SystemExit(f"phase l: {label} {mode} serving did not "
                                 "finish")
            counters = capture.stats()
            ms.sort()
            out[mode] = {"p50_ms": ms[len(ms) // 2], "busy_ms":
                         prof["device_busy_ms"], "wall_ms": prof["wall_ms"],
                         "launches": prof["launches"],
                         "requests_per_s": n_req / wall,
                         "counters": counters}
            log(f"[l] {label} {mode}: predict p50 {out[mode]['p50_ms']:.3f} "
                f"ms (host clock, {CAPTURE_PREDICTS} predicts); one "
                f"profiled: busy {prof['device_busy_ms']:.3f} ms of "
                f"{prof['wall_ms']:.3f} ms wall, {prof['launches']} kernels; "
                f"BatchServer {n_req / wall:.2f} requests/s")
            if mode == "captured" and (counters["capture_retraces"] or
                                       counters["capture_fallback_eager"]):
                raise SystemExit(f"phase l: {label} retraced or ran eagerly "
                                 f"after warm-up: {counters}")
    ex = pred._exec
    bucket = pred.bucket_for(len(batch))
    sig = next(s for s in ex.compiled_signatures if s[0][0][0] == bucket)
    out["nodes"] = graph_nodes(ex, label.replace(" ", "_"), node_parts, sig)
    out["verdict"] = judge(torch, f"{label} predict", {"o": outs["eager"]},
                           {"o": outs["eager2"]}, {"o": outs["captured"]})
    return out


def capture_serving(torch, mx, capture):
    """The LM bucket-8 predict (phase d's model) and the ResNet-50
    bucket-32 predict (phase f's), captured against eager."""
    import numpy as np

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon.model_zoo import transformer, vision

    rng = np.random.RandomState(0)
    lm = transformer.transformer_lm(
        vocab=VOCAB, units=UNITS, num_heads=HEADS, num_layers=LAYERS,
        max_len=T, impl="flash", prefix="tlm_")
    lm.initialize(mx.init.Xavier(),
                  generator=torch.Generator(device="cuda").manual_seed(0))
    lm.cast("bfloat16")
    pred = serving.Predictor.from_block(
        lm, input_shapes={"data": (T,)}, batch_sizes=(1, 8),
        warmup=False).warmup(dtype="int64")
    ids = rng.randint(0, VOCAB, (BATCH, T)).astype(np.int64)
    reqs = [[rng.randint(0, VOCAB, (1, T)).astype(np.int64)
             for _ in range(8)] for _ in range(4)]
    lm_rec = serve_both(torch, capture, serving, pred, ids, reqs, 8,
                        "LM bucket-8", ("flash_fwd",),
                        ("flash_fwd_tc_kernel",))
    k1 = lm_rec["nodes"]["flash_fwd_tc_kernel"]
    log(f"[l] LM bucket-8 graph: {lm_rec['nodes']['kernels']} kernel nodes, "
        f"K1 {k1} (want {LAYERS}) {'ok' if k1 == LAYERS else 'FAIL'}")
    if k1 != LAYERS:
        raise SystemExit("phase l: the LM bucket-8 graph does not hold 12 "
                         "K1 nodes")
    del pred, lm
    torch.cuda.empty_cache()

    net = vision.resnet50_v1(layout="NHWC", stem="s2d", classes=1000)
    net.initialize(mx.init.Xavier(factor_type="in", magnitude=2),
                   generator=torch.Generator(device="cuda").manual_seed(0))
    net.cast("bfloat16")
    pred = serving.Predictor.from_block(
        net, input_shapes={"data": (3, 224, 224)}, batch_sizes=(1, 32),
        dtype="bfloat16")
    images = rng.rand(32, 3, 224, 224).astype(np.float32)
    reqs = [[rng.rand(1, 3, 224, 224).astype(np.float32)
             for _ in range(32)] for _ in range(4)]
    rn_rec = serve_both(torch, capture, serving, pred, images, reqs, 32,
                        "ResNet-50 bucket-32", ("fprop", "conv"))
    del pred, net
    torch.cuda.empty_cache()
    return {"lm": lm_rec, "resnet": rn_rec}


def capture_phase(torch, mx, kernels):
    """Phase l: capture.py on the card."""
    from mxnet_tpu_torch import capture

    from mxnet_tpu_torch.ops import decode_attention

    alone = capture_kernels_alone(torch, kernels, capture)
    alone += capture_decode_alone(torch, decode_attention, capture)
    lm = capture_lm_step(torch, mx, kernels, capture)
    resnet = capture_resnet_step(torch, mx, capture)
    served = capture_serving(torch, mx, capture)
    return {"alone": alone, "lm_step": lm, "resnet_step": resnet,
            "serving": served}


# ------------------------------------------------------------------ phase m
def train_fp32_lm(torch, mx, kernels):
    """Phase h's model and batch left in fp32, mxnet_tpu's default dtype:
    GPT-2-small widths at full depth, B=8, T=1024, seeded Xavier weights,
    gluon.Trainer Adam (lr 1e-3), SoftmaxCrossEntropyLoss, 10 eager steps.
    Asserts finite losses, loss 10 at least 0.5 below loss 1, and exactly
    12 K1 and 12 K2 launches a step, all on the 3xTF32 route; reports the
    median step on the host clock (steps 2-10, profiler off), tokens/s and
    peak memory; then profiles one more step for K1's and K2's device ms
    and the step's busy time."""
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = transformer.transformer_lm(
        vocab=VOCAB, units=UNITS, num_heads=HEADS, num_layers=LAYERS,
        max_len=T, impl="flash", prefix="tlm_")
    net.initialize(mx.init.Xavier(), generator=gen)   # fp32, gpu(0)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = lm_batch(torch, BATCH, T, VOCAB)

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        trainer.step(1)
        return loss

    # the main path: counts set to 0 just before it, read just after
    zero_counts(kernels)
    losses, step_ms, per_step = [], [], []
    for i in range(TRAIN_STEPS):
        k1 = dict(kernels.flash_attention.launches_by_route)
        k2 = dict(kernels.flash_attention_backward.launches_by_route)
        t0 = time.perf_counter()
        losses.append(step().item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append((
            {r: n - k1[r] for r, n in
             kernels.flash_attention.launches_by_route.items()},
            {r: n - k2[r] for r, n in
             kernels.flash_attention_backward.launches_by_route.items()}))
        log(f"[m] step {i + 1}: loss {losses[-1]:.4f}, {step_ms[-1]:.2f} ms "
            f"(host clock), K1 {per_step[-1][0]}, K2 {per_step[-1][1]}")
    k1_total = kernels.flash_attention.launches
    k1_by_route = dict(kernels.flash_attention.launches_by_route)
    k2_total = kernels.flash_attention_backward.launches
    k2_by_route = dict(kernels.flash_attention_backward.launches_by_route)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    timed = sorted(step_ms[1:])
    median = timed[len(timed) // 2]
    tokens_per_s = BATCH * T / (median / 1e3)
    drop = losses[0] - losses[-1]
    want = {"tc": 0, "tf32x3": LAYERS, "simt": 0}
    ok = (all(math.isfinite(v) for v in losses) and drop >= 0.5
          and all(a == b == want for a, b in per_step))
    log(f"[m] fp32 LM, {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (drop {drop:.4f}, want >= 0.5); median step "
        f"{median:.2f} ms over steps 2-{TRAIN_STEPS} (host clock, profiler "
        f"off), {tokens_per_s:.1f} tokens/s; peak memory {peak_gib:.2f} GiB;"
        f" K1 launches {k1_total} {k1_by_route}, K2 launches {k2_total} "
        f"{k2_by_route} (want {LAYERS} K1 and {LAYERS} K2 a step, all "
        f"tf32x3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase m: the fp32 training step failed its checks")

    torch.cuda.synchronize()
    prof = profile_window(torch, step, "one fp32 training step", "m",
                          ("flash_fwd", "flash_bwd"), top=12)
    k1_ms = sum(r["ms"] for r in prof["all"] if "flash_fwd" in r["kernel"])
    k2_ms = sum(r["ms"] for r in prof["all"] if "flash_bwd" in r["kernel"])
    groups = step_breakdown(prof["all"])
    busy = prof["device_busy_ms"]
    log(f"[m] one fp32 step profiled: device busy {busy:.3f} ms of "
        f"{prof['wall_ms']:.3f} ms wall (profiler on); K1 {k1_ms:.3f} ms "
        f"({k1_ms / LAYERS:.4f} a launch), K2 {k2_ms:.3f} ms "
        f"({k2_ms / LAYERS:.4f} a launch); by group:")
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"[m]   {ms:9.3f} ms  x{n:<5d} {group} ({ms / busy:.1%})")
    del net, trainer
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms, "median_step_ms": median,
            "tokens_per_s": tokens_per_s, "peak_gib": peak_gib,
            "k1_launches": k1_total, "k1_launches_by_route": k1_by_route,
            "k2_launches": k2_total, "k2_launches_by_route": k2_by_route,
            "profile": {"wall_ms": prof["wall_ms"], "device_busy_ms": busy,
                        "launches": prof["launches"], "k1_ms": k1_ms,
                        "k2_ms": k2_ms, "top": prof["top"],
                        "groups": {g: {"ms": ms, "launches": n}
                                   for g, (ms, n) in groups.items()}}}


# ------------------------------------------------------------------- K4
# K4 (paged decode attention) against its plain version on the same
# inputs: fp32 q within DECODE_TOL of max|ref| (f32 sums in other orders;
# the CPU plain version reads <= 1e-6 against mxnet_tpu's), 16-bit q within
# DECODE_ULP of the plain version's rounded output (two f32 values a few
# f32 ulps apart round to neighbouring 16-bit values at most)
DECODE_TOL = 1e-5
DECODE_ULP = 1
DECODE_PS = 16              # the slice's page size
DECODE_MAX_PAGES = T // DECODE_PS


@contextlib.contextmanager
def plain_guard(da):
    """While open, K4's plain version raises on a CUDA tensor: the wrapper
    must launch the kernel for those, never fall back."""
    plain = da.paged_decode_attention_reference

    def guard(q, *args, **kwargs):
        if q.is_cuda:
            raise SystemExit("a CUDA tensor reached K4's plain version")
        return plain(q, *args, **kwargs)

    da.paged_decode_attention_reference = guard
    try:
        yield
    finally:
        da.paged_decode_attention_reference = plain


def decode_pool(torch, da, gen, pages, page_size, h, d, int8,
                misaligned=False):
    """Seeded K and V pages (pages, page_size, H, D) ~ N(0, 1): fp32, or
    int8 with scales by kv_quantize. ``misaligned`` moves each int8 tensor
    one element off a 16-byte boundary (contiguous all the same), which
    the route rule must send to the one-element-a-lane kernel. Returns
    (kp, vp, ks, vs)."""
    kf = torch.randn((pages, page_size, h, d), generator=gen, device="cuda")
    vf = torch.randn((pages, page_size, h, d), generator=gen, device="cuda")
    if not int8:
        return kf, vf, None, None
    out = [t for x in (kf, vf) for t in da.kv_quantize(x)]
    if misaligned:
        def shift(t):
            buf = torch.empty(t.numel() + 16, dtype=t.dtype, device="cuda")
            view = buf[1:1 + t.numel()].view(t.shape)
            view.copy_(t)
            return view
        out = [shift(t) for t in out]
    kp, ks, vp, vs = out
    return kp, vp, ks, vs


def decode_route_of(da, q, kp, vp, ks, vs):
    """The route _decode_route gives these operands."""
    ptrs = [] if ks is None else [t.data_ptr() for t in (kp, vp, ks, vs)]
    return da._decode_route(kp.dtype, q.shape[2], q.shape[1], kp.shape[1],
                            ptrs)


def decode_table(torch, gen, lengths, page_size, max_pages, pages,
                 junk=False):
    """An int32 page table whose rows hold their pages in a shuffled order
    of the pool's pages 1..pages-1 (no page shared); entries past a row's
    pages are scratch page 0, or with ``junk`` other pool pages (which the
    kernel must not read). Returns (table, lengths) on the card."""
    perm = (torch.randperm(pages - 1, generator=gen, device="cuda") + 1).to(
        torch.int32)
    table = torch.zeros((len(lengths), max_pages), dtype=torch.int32,
                        device="cuda")
    if junk:
        table.random_(1, pages, generator=gen)
    used = 0
    for i, n in enumerate(lengths):
        k = -(-n // page_size)
        table[i, :k] = perm[used:used + k]
        used += k
    if used > pages - 1:
        raise SystemExit("decode_table: the pool is too small")
    return table, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def check_decode_attention(torch, da):
    """Phase b for K4: fp32, bf16 and fp16 q over fp32 and int8 pools,
    shuffled tables (some with other pages past each row's length), ragged
    lengths (1, page_size - 1, page_size, page_size + 1, full, others, 0),
    D 64 and the odd D 65, the slice's shape (B=32, H=12, D=64, pages of
    16, 64 a row) and an int8 pool off its 16-byte alignment. Every int8
    pool of D 64 must take route "int8_bulk" (whole pages by bulk copy),
    D 65 and the misaligned pool route "int8". Each case launched twice
    (bitwise equal, one launch a call on the route it names, no call of
    the plain version on the card) and held to the plain version; rows of
    length 0 must be exactly 0."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    ps, mp = DECODE_PS, DECODE_MAX_PAGES
    full = ps * mp
    ragged = [1, ps - 1, ps, ps + 1, full, 0, 37, 700]
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = [(qd, int8, h, d, ragged, junk, False)
             for qd in (f32, bf16) for int8 in (False, True)
             for h, d, junk in ((12, 64, False), (3, 65, True))]
    slice_lengths = torch.randint(1, full + 1, (32,), generator=gen,
                                  device="cuda").tolist()
    slice_lengths[:3] = [0, 1, full]
    cases += [(qd, int8, HEADS, UNITS // HEADS, slice_lengths, False, False)
              for qd in (f32, bf16) for int8 in (False, True)]
    cases += [(f16, True, 4, 64, ragged, True, False),
              (f16, True, HEADS, UNITS // HEADS, slice_lengths, False, False),
              (f32, True, 12, 64, ragged, True, False),
              (bf16, True, 12, 64, ragged, True, True)]
    records = []
    errs = {r: 0.0 for r in da.paged_decode_attention.launches_by_route}
    for qd, int8, h, d, lengths, junk, misaligned in cases:
        pages = sum(-(-n // ps) for n in lengths) + 1
        kp, vp, ks, vs = decode_pool(torch, da, gen, pages, ps, h, d, int8,
                                     misaligned)
        table, lens = decode_table(torch, gen, lengths, ps, mp, pages, junk)
        q = torch.randn((len(lengths), h, d), generator=gen,
                        device="cuda").to(qd)
        args = (q, kp, vp, table, lens)
        kw = {"k_scales": ks, "v_scales": vs}
        want_route = ("float32" if not int8 else
                      "int8" if d % 16 or misaligned else "int8_bulk")
        route = decode_route_of(da, q, kp, vp, ks, vs)
        before = dict(da.paged_decode_attention.launches_by_route)
        with plain_guard(da):
            out = da.paged_decode_attention(*args, **kw)
            again = da.paged_decode_attention(*args, **kw)
        launched = {r: n - before[r] for r, n in
                    da.paged_decode_attention.launches_by_route.items()
                    if n != before[r]}
        ref = da.paged_decode_attention_reference(*args, **kw)
        torch.cuda.synchronize()
        zero = lens == 0
        zeros_ok = bool((out[zero] == 0).all())
        bitwise = torch.equal(out, again)
        if qd == f32:
            err, limit = rel_err(out, ref), DECODE_TOL
        else:
            err, limit = ulp_err(torch, out, ref), DECODE_ULP
        abs_err = (out.float() - ref.float()).abs().max().item()
        errs[route] = max(errs[route], abs_err)
        ok = (err <= limit and zeros_ok and bitwise and route == want_route
              and launched == {route: 2} and out.dtype == qd
              and out.shape == q.shape)
        name = (f"K4 q {str(qd)[6:]} kv {'int8' if int8 else 'float32'} "
                f"route {route} B={len(lengths)} H={h} D={d}"
                f"{' junk past length' if junk else ''}"
                f"{' misaligned pool' if misaligned else ''}")
        log(f"[b] {name}: err {err:.3g} ({'ulp' if qd != f32 else 'rel'}, "
            f"limit {limit:g}); max|diff| {abs_err:.3g}; length-0 rows "
            f"exactly 0: {zeros_ok}; second launch bitwise: {bitwise}; "
            f"launches {launched} (want {{'{want_route}': 2}}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase b: {name} disagrees with its plain "
                             "version")
        records.append({"case": name, "route": route, "err": err,
                        "limit": limit, "max_abs_err": abs_err,
                        "bitwise": bitwise})
    return records, errs


def write_rows(torch, gen, n, h, d, dtype):
    """K and V as the model hands them to the write: the (N, H, D) views
    of an (N, 3 H D) qkv projection output, seeded, with an all-zero row
    and a row of exact .5 ties (amax 127, scale 1)."""
    qkv = torch.randn((n, 3 * h * d), generator=gen, device="cuda") * \
        torch.rand((n, 1), generator=gen, device="cuda") * 4
    u = h * d
    qkv[0, u:] = 0
    qkv[1, u:u + 6] = torch.tensor([127.0, 0.5, 1.5, -2.5, -126.5, 63.5],
                                   device="cuda")
    qkv = qkv.to(dtype)
    _, k, v = (qkv[:, i * u:(i + 1) * u].view(n, h, d) for i in range(3))
    return k, v


def check_kv_write(torch, da):
    """Phase b for the int8 write (csrc/kv_quantize_write.cu): K and V of
    one layer, read through the qkv views' strides in fp32, bf16 and fp16,
    written into a pool of random bytes at the decode step's shape (32
    rows, H=12, D=64), a prefill bucket's (512 rows, the padded ones on
    scratch page 0) and an odd D (65); the int8 bytes and scales bitwise
    equal to the plain version (kv_quantize and index_put_) outside page 0,
    every byte outside the written slots unchanged, one launch a call."""
    gen = torch.Generator(device="cuda").manual_seed(53)
    ps = DECODE_PS
    records = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for n, h, d, live in ((32, HEADS, UNITS // HEADS, 32),
                              (512, HEADS, UNITS // HEADS, 300),
                              (24, 3, 65, 24)):
            pages = -(-n // ps) * 2 + 1
            k, v = write_rows(torch, gen, n, h, d, dtype)
            perm = torch.randperm((pages - 1) * ps, generator=gen,
                                  device="cuda")[:n] + ps
            page_idx = torch.where(torch.arange(n, device="cuda") < live,
                                   perm // ps, 0)
            slot_idx = perm % ps
            pool = [torch.randint(-127, 128, (pages, ps, h, d),
                                  generator=gen, device="cuda",
                                  dtype=torch.int8) for _ in range(2)]
            pool += [torch.rand((pages, ps, h), generator=gen,
                                device="cuda") + 0.5 for _ in range(2)]
            got = [t.clone() for t in pool]
            want = [t.clone() for t in pool]
            before = da.kv_quantize_write.launches
            with write_plain_guard(da):
                da.kv_quantize_write(*got, k, v, page_idx, slot_idx)
            launched = da.kv_quantize_write.launches - before
            da.kv_quantize_write_reference(*want, k, v, page_idx, slot_idx)
            torch.cuda.synchronize()
            same = all(torch.equal(a[1:], b[1:]) for a, b in zip(got, want))
            # the largest difference outside page 0, int8 bytes as ints
            err = max((a[1:].float() - b[1:].float()).abs().max().item()
                      for a, b in zip(got, want))
            written = torch.zeros((pages, ps), dtype=torch.bool,
                                  device="cuda")
            written[page_idx, slot_idx] = True
            kept = all(torch.equal(a[~written], b[~written])
                       for a, b in zip(got, pool))
            ok = same and kept and launched == 1
            name = (f"kv_quantize_write {str(dtype)[6:]} N={n} ({live} "
                    f"live) H={h} D={d}")
            log(f"[b] {name}: int8 bytes and scales == plain version "
                f"bitwise (page 0 aside): {same}, max |got - plain| "
                f"{err!r}; bytes outside the written "
                f"slots unchanged: {kept}; launches {launched} (want 1) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"phase b: {name} disagrees with its plain "
                                 "version")
            records.append({"case": name, "bitwise": same, "kept": kept,
                            "max_abs_err": err})
    return records


@contextlib.contextmanager
def write_plain_guard(da):
    """While open, the int8 write's plain version raises on a CUDA
    tensor: the wrapper must launch its kernel for those."""
    plain = da.kv_quantize_write_reference

    def guard(*args):
        if args[4].is_cuda:
            raise SystemExit("a CUDA tensor reached the int8 write's plain "
                             "version")
        return plain(*args)

    da.kv_quantize_write_reference = guard
    try:
        yield
    finally:
        da.kv_quantize_write_reference = plain


def decode_work(lengths, b, h, d, max_pages, kv_itemsize, q_itemsize,
                int8):
    """(FLOP, bytes) one K4 call needs for these lengths: 4 D FLOP per
    (token, head) (q.k and p.v); each live K and V element read once (with
    its f32 scale for int8), q, the table and lengths read once, O written
    once."""
    tokens = float(sum(lengths))
    flops = 4.0 * d * h * tokens
    nbytes = (2.0 * tokens * h * (d * kv_itemsize + (4 if int8 else 0))
              + 2.0 * b * h * d * q_itemsize + 4.0 * b * (max_pages + 1))
    return flops, nbytes


def time_decode_attention(torch, da):
    """Phase c for K4 at the slice's decode shape: B=32 slots, H=12, D=64,
    pages of 16, 64 pages a row, every row 1024 tokens long, bf16 q (the
    model's), fp32 and int8 pools. Each of the 12 layers has a pool of its
    own (32 x 64 + 1 pages), and the calls rotate over them, so no call
    finds its pages in the 50 MB L2 (the int8 pool of one layer is 53 MB).
    The int8 pools take route "int8_bulk"; the one-element-a-lane kernel
    (route "int8") is timed on the same pools. Device time beside the
    bytes bound at 3.35 TB/s, the plain version, and one
    scaled_dot_product_attention call over the same KV already contiguous
    (B, H, 1024, D): the same attention without a page table (no PyTorch
    call takes one). Both int8 routes are also timed with every row at
    phase n's profiled position (353 tokens: 23 of the 64 pages)."""
    import torch.nn.functional as F

    b, h, d, ps, mp = 32, HEADS, UNITS // HEADS, DECODE_PS, DECODE_MAX_PAGES
    pages = b * mp + 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(43)
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    lengths = [mp * ps] * b
    short = [DECODE_STEP_POSITION + 1] * b
    table, lens = decode_table(torch, gen, lengths, ps, mp, pages)
    short_lens = torch.tensor(short, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(d)
    out = {}
    for int8 in (False, True):
        pools = [decode_pool(torch, da, gen, pages, ps, h, d, int8)
                 for _ in range(LAYERS)]
        turn = [0]

        def rotate(fn, lens=lens):
            def call():
                i = turn[0] % LAYERS
                turn[0] += 1
                kp, vp, ks, vs = pools[i]
                return fn(q, kp, vp, table, lens, k_scales=ks, v_scales=vs)
            return call

        def forced(route):
            def fn(q, kp, vp, table, lens, k_scales, v_scales):
                return da._launch(q, kp, vp, table, lens, scale, k_scales,
                                  v_scales, route=route)
            return fn

        # the plain version issues ~300 launches a call: 2 calls stay
        # inside the launch queue while the card spins
        plain_ms = device_ms(rotate(da.paged_decode_attention_reference),
                             n=2)
        routes = ("int8_bulk", "int8") if int8 else ("float32",)
        for route in routes:
            before = dict(da.paged_decode_attention.launches_by_route)
            fn = da.paged_decode_attention if route != "int8" else \
                forced("int8")
            ms = device_ms(rotate(fn), n=24)
            took = [r for r, n in da.paged_decode_attention.launches_by_route
                    .items() if n != before[r]]
            if took != [route]:
                raise SystemExit(f"phase c: K4 {route} took route {took}")
            short_ms = device_ms(rotate(fn, short_lens), n=24)
            flops, nbytes = decode_work(lengths, b, h, d, mp,
                                        1 if int8 else 4, 2, int8)
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = flops / PEAK_FP32_FMA_FLOPS * 1e3  # f32 on the CUDA cores
            bound_ms = max(t_bytes, t_ops)
            short_bytes = decode_work(short, b, h, d, mp, 1 if int8 else 4,
                                      2, int8)[1]
            bulk = route == "int8_bulk"
            out[route] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops,
                "tb_per_s": nbytes / (ms * 1e-3) / 1e12,
                "splits": ((da.int8_splits(b, mp, sms), None) if bulk
                           else da.decode_splits(b, mp, sms)),
                "stages": (da._int8_geometry(h, d, ps)["stages"] if bulk
                           else None),
                "step_position_ms": short_ms,
                "step_position_bound_ms": short_bytes / PEAK_BYTES * 1e3}
        del pools
        torch.cuda.empty_cache()
    # the same attention, KV contiguous, no page table: fp32 and bf16
    qc = q.float().view(b, h, 1, d)
    kc = torch.randn((b, h, mp * ps, d), generator=gen, device="cuda")
    vc = torch.randn((b, h, mp * ps, d), generator=gen, device="cuda")
    sdpa32 = device_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc),
                       n=24)
    kc, vc, qc = kc.bfloat16(), vc.bfloat16(), qc.bfloat16()
    sdpa16 = device_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc),
                       n=24)
    del kc, vc
    torch.cuda.empty_cache()
    for route, r in out.items():
        r["contiguous_sdpa_fp32_ms"] = sdpa32
        r["contiguous_sdpa_bf16_ms"] = sdpa16
        splits, per = r["splits"]
        deal = (f"{splits} splits of {per} pages" if per else
                f"{splits} splits, a row's pages dealt round-robin, "
                f"{r['stages']} stages")
        log(f"[c] paged_decode_attn route {route} (B={b}, H={h}, D={d}, "
            f"pages of {ps}, {mp * ps} tokens a row, bf16 q, {deal}; "
            f"{LAYERS} pools rotated): {r['ms']:.4f} "
            f"ms device, {r['tb_per_s']:.2f} TB/s, bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}: {r['bytes'] / 1e6:.1f} MB; "
            f"{r['bound_ms'] / r['ms']:.1%} of it); rows at "
            f"{DECODE_STEP_POSITION + 1} tokens {r['step_position_ms']:.4f} "
            f"ms (bound {r['step_position_bound_ms']:.4f}); plain version "
            f"{r['plain_ms']:.3f} ms; the same attention without a page "
            f"table, KV contiguous, one SDPA call: fp32 {sdpa32:.4f} ms, "
            f"bf16 {sdpa16:.4f} ms")
    return out


def write_work(n, h, d, itemsize):
    """Bytes the int8 write must move: K and V read once, their int8 rows
    and f32 scales written once, the two int64 index vectors read once."""
    return 2.0 * n * h * (d * itemsize + d + 4) + 2.0 * 8 * n


def time_kv_write(torch, da):
    """Phase c for the int8 write at the decode step's shape: 32 rows,
    H=12, D=64, bf16 views of the qkv output, into a pool of phase n's
    size (2049 pages of 16): the kernel (one launch) beside the plain chain
    (kv_quantize's elementwise and reduction kernels and two index_put_,
    for K and for V) and the bytes bound."""
    gen = torch.Generator(device="cuda").manual_seed(59)
    n, h, d, ps = DECODE_SEQS, HEADS, UNITS // HEADS, DECODE_PS
    pages = DECODE_SEQS * DECODE_MAX_PAGES + 1
    k, v = write_rows(torch, gen, n, h, d, torch.bfloat16)
    perm = torch.randperm((pages - 1) * ps, generator=gen,
                          device="cuda")[:n] + ps
    page_idx, slot_idx = perm // ps, perm % ps
    pool = [torch.zeros((pages, ps, h, d), dtype=torch.int8, device="cuda")
            for _ in range(2)]
    pool += [torch.ones((pages, ps, h), device="cuda") for _ in range(2)]
    ms = device_ms(lambda: da.kv_quantize_write(*pool, k, v, page_idx,
                                                slot_idx), n=24)
    plain_ms = device_ms(lambda: da.kv_quantize_write_reference(
        *pool, k, v, page_idx, slot_idx), n=8)
    nbytes = write_work(n, h, d, 2)
    bound_ms = nbytes / PEAK_BYTES * 1e3
    rec = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes", "bytes": nbytes}
    log(f"[c] kv_quantize_write (N={n} rows, H={h}, D={d}, bf16 qkv views, "
        f"K and V): {ms:.4f} ms device, bound {bound_ms:.5f} ms (bytes: "
        f"{nbytes / 1e3:.1f} KB); the plain chain (kv_quantize + index_put_, "
        f"K and V) {plain_ms:.4f} ms")
    return rec


def capture_decode_alone(torch, da, capture):
    """Phase l for K4: each route captured alone in a graph (the pool is
    the graph's state: fp32 for "float32", int8 for "int8_bulk", an int8
    pool off its 16-byte alignment for "int8"), replayed on new q, table
    and lengths: bitwise equal to an eager launch on those inputs, 3
    launches enqueued at warm-up and capture, none at a replay, 2 kernel
    nodes (splits, combine)."""
    gen = torch.Generator(device="cuda").manual_seed(47)
    ps, mp, h, d = DECODE_PS, 8, HEADS, UNITS // HEADS
    first, second = [5, 16, 100, 0], [128, 1, 17, 64]
    records = []
    for route in ("float32", "int8_bulk", "int8"):
        pages = 4 * mp + 1
        kp, vp, ks, vs = decode_pool(torch, da, gen, pages, ps, h, d,
                                     route != "float32", route == "int8")

        def fn(q, table, lens):
            return da.paged_decode_attention(q, kp, vp, table, lens,
                                             k_scales=ks, v_scales=vs)

        def inputs(lengths):
            table, lens = decode_table(torch, gen, lengths, ps, mp, pages)
            q = torch.randn((len(lengths), h, d), generator=gen,
                            device="cuda").to(torch.bfloat16)
            return q, table, lens

        ex = capture.CapturedExec(
            fn, label=f"K4 {route} alone", device="cuda",
            state=lambda: [t for t in (kp, vp, ks, vs) if t is not None])
        before = da.paged_decode_attention.launches_by_route[route]
        ex(*inputs(first))
        enqueued = da.paged_decode_attention.launches_by_route[route] - before
        new = inputs(second)
        got = ex(*new)
        replays = (da.paged_decode_attention.launches_by_route[route]
                   - before - enqueued)
        want = fn(*new)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        nodes = graph_nodes(ex, f"K4_{route}_alone")
        ok = same and enqueued == 3 and replays == 0 and nodes["kernels"] == 2
        log(f"[l] K4 ({route}) captured alone: replay on new q, table and "
            f"lengths == eager launch bitwise: {same}; wrapper launches at "
            f"warm-up + capture {enqueued} (want 3), at a replay {replays} "
            f"(want 0); graph kernel nodes {nodes['kernels']} (want 2) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase l: K4 ({route}) replayed from a graph "
                             "differs from its eager launch")
        records.append({"kernel": "K4", "route": route, "bitwise": same,
                        "nodes": nodes["kernels"]})
    return records


# ------------------------------------------------------------------ phase n
# The decode slice at full width: 32 slots of whole 1024-token contexts in
# pages of 16 (scratch page included), prefill buckets up to 512, 64
# requests from 4 threads, prompts of 64-512 seeded tokens, 128 new tokens
DECODE_SEQS = 32
DECODE_BUCKETS = (64, 128, 256, 512)
DECODE_REQUESTS, DECODE_THREADS, DECODE_NEW = 64, 4, 128
DECODE_PROMPTS = (64, 512)
DECODE_STEP_POSITION = 352   # the profiled step's position: the traffic's
#                              mean context (288-token prompt + 64)
DECODE_LOGIT_TOL = 1e-3      # teacher-forced fp32 logits, of max|logits|
DECODE_ROUTE = {"float32": "float32", "int8": "int8_bulk"}   # K4's, by pool


def decode_net(torch, mx, dtype):
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    gen = torch.Generator(device="cuda").manual_seed(0)
    net = transformer.transformer_lm(
        vocab=VOCAB, units=UNITS, num_heads=HEADS, num_layers=LAYERS,
        max_len=T, impl="flash", prefix="tlm_")
    net.initialize(mx.init.Xavier(), generator=gen)   # default ctx: gpu(0)
    if dtype != "float32":
        net.cast(dtype)
    return net


def decode_traffic(torch, kernels, da, net, kv):
    """One run of phase n on ``net`` with a ``kv`` pool: the predictor
    built (every graph captured at its warm-up), then DECODE_REQUESTS
    streams through DecodeBatcher from DECODE_THREADS threads."""
    import numpy as np

    from mxnet_tpu_torch import capture, serving
    from mxnet_tpu_torch.serving.batcher import DecodeBatcher

    torch.cuda.empty_cache()
    # the main path: counts set to 0 just before it, read just after
    zero_counts(kernels)
    misses0 = capture.stats()["capture_misses"]
    t0 = time.perf_counter()
    pred = serving.DecodePredictor(
        net, page_size=DECODE_PS, num_pages=DECODE_SEQS * DECODE_MAX_PAGES
        + 1, max_seqs=DECODE_SEQS, prefill_buckets=DECODE_BUCKETS,
        kv_dtype=kv)
    build_s = time.perf_counter() - t0
    captured = capture.stats()["capture_misses"] - misses0
    capture.clear_retrace_log()
    misses1 = capture.stats()["capture_misses"]
    serving.reset_stats()
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, VOCAB, rs.randint(DECODE_PROMPTS[0],
                                               DECODE_PROMPTS[1] + 1))
               .tolist() for _ in range(DECODE_REQUESTS)]
    results = [None] * DECODE_REQUESTS
    errors = []
    bat = DecodeBatcher(pred)

    def client(k):
        try:
            mine = range(k, DECODE_REQUESTS, DECODE_THREADS)
            streams = [(i, bat.submit(prompts[i], DECODE_NEW)) for i in mine]
            for i, s in streams:
                results[i] = s.result(timeout=600)
        except Exception as e:   # noqa: BLE001 -- reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(DECODE_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    wall = time.perf_counter() - t0
    bat.close()
    st = serving.stats()
    launches = da.paged_decode_attention.launches
    by_route = dict(da.paged_decode_attention.launches_by_route)
    writes = da.kv_quantize_write.launches
    after_misses = capture.stats()["capture_misses"] - misses1
    retraces = capture.retrace_log()
    tokens = sum(len(r) for r in results if r is not None)
    ok_tokens = all(r is not None and len(r) == DECODE_NEW and
                    all(0 <= t < VOCAB for t in r) for r in results)
    want = dict.fromkeys(by_route, 0)
    want[DECODE_ROUTE[kv]] = 3 * LAYERS
    # one int8 write a layer in each prefill bucket and the step, at their
    # 2 warm-up runs and capture
    want_writes = 0 if kv == "float32" else \
        (len(DECODE_BUCKETS) + 1) * 3 * LAYERS
    ok = (not errors and ok_tokens and after_misses == 0 and not retraces
          and by_route == want and writes == want_writes
          and pred.pool.in_use == 0
          and st["decode_sequences"] == DECODE_REQUESTS
          and st["decode_tokens"] == DECODE_REQUESTS * DECODE_NEW)
    rec = {
        "kv_dtype": kv, "build_s": build_s, "graphs_captured": captured,
        "captures_after_warmup": after_misses, "retraces": retraces,
        "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
        "ttft_p50_ms": st["decode_p50_ttft_us"] / 1e3,
        "ttft_p99_ms": st["decode_p99_ttft_us"] / 1e3,
        "itl_p50_ms": st["decode_p50_itl_us"] / 1e3,
        "itl_p99_ms": st["decode_p99_itl_us"] / 1e3,
        "steps": st["decode_steps"], "prefills": st["decode_prefills"],
        "pages_peak": st["decode_pages_inuse_peak"],
        "preemptions": st["decode_preemptions"],
        "backpressure": st["decode_backpressure"],
        "ttft_misses": st["decode_ttft_misses"],
        "kv_hbm_bytes": pred.kv_hbm_bytes, "launches": launches,
        "launches_by_route": by_route, "write_launches": writes,
        "errors": errors}
    log(f"[n] kv {kv}: predictor built in {build_s:.2f} s ({captured} graphs "
        f"captured: {len(DECODE_BUCKETS)} prefill buckets, the step, the "
        f"probe), pool {pred.kv_hbm_bytes / 1e9:.3f} GB; "
        f"{DECODE_REQUESTS} requests from {DECODE_THREADS} threads: "
        f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s; "
        f"TTFT p50 {rec['ttft_p50_ms']:.2f} ms p99 {rec['ttft_p99_ms']:.2f} "
        f"ms; inter-token p50 {rec['itl_p50_ms']:.3f} ms p99 "
        f"{rec['itl_p99_ms']:.3f} ms; {rec['steps']} steps, "
        f"{rec['prefills']} prefills, pages at peak {rec['pages_peak']}, "
        f"preemptions {rec['preemptions']}, backpressure "
        f"{rec['backpressure']}, TTFT misses ({bat.ttft_slo_s * 1e3:g} ms) "
        f"{rec['ttft_misses']}; "
        f"captures after warm-up {after_misses}, retrace log "
        f"{len(retraces)}; K4 launches {launches} {by_route} (want "
        f"{3 * LAYERS} on {DECODE_ROUTE[kv]}: 2 warm-up runs and the capture "
        f"of the step); int8 write launches {writes} (want {want_writes}: "
        f"{LAYERS} in each of {len(DECODE_BUCKETS)} prefill buckets and the "
        f"step, 3 times) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"phase n: decode with {kv} KV failed its checks: "
                         f"{errors[:2]}")
    return pred, rec


def decode_step_profile(torch, pred, kv):
    """The step with every slot live at position DECODE_STEP_POSITION:
    median host-clock ms of 20 steps (each ends by reading the next
    tokens), and one step profiled for busy / wall and K4's share."""
    import numpy as np

    n = pred.max_seqs
    per = -(-(DECODE_STEP_POSITION + 1) // pred.page_size)
    pages = pred.pool.alloc(n * per)
    table = np.zeros((n, pred.max_pages), np.int32)
    table[:, :per] = np.asarray(pages, np.int32).reshape(n, per)
    toks = np.arange(n, dtype=np.int32)
    pos = np.full((n,), DECODE_STEP_POSITION, np.int32)
    act = np.ones((n,), np.int32)
    try:
        pred.step(toks, pos, act, table)
        ms = []
        for _ in range(20):
            t0 = time.perf_counter()
            pred.step(toks, pos, act, table)
            ms.append((time.perf_counter() - t0) * 1e3)
        prof = profile_window(torch, lambda: pred.step(toks, pos, act, table),
                              f"one decode step (kv {kv}, {n} live slots)",
                              "n", ("paged_decode_attn",), top=6)
    finally:
        pred.pool.free(pages)
    ms.sort()
    k4_ms = prof["kernel_ms"]
    write = [r for r in prof["all"] if "kv_quantize_write" in r["kernel"]]
    busy = prof["device_busy_ms"]
    return {"step_ms": ms[len(ms) // 2], "busy_ms": busy,
            "wall_ms": prof["wall_ms"], "k4_ms": k4_ms,
            "k4_share": k4_ms / busy if busy else None,
            "write_ms": sum(r["ms"] for r in write),
            "write_launches": sum(r["count"] for r in write),
            "launches": prof["launches"], "top": prof["top"]}


def decode_teacher_forced(torch, mx):
    """Correctness on an fp32 copy of the model with fp32 KV: 4 seeded
    prompts greedy-decoded 32 tokens together (4 slots of one step), each
    step's logits held to the flat forward's at the same position on the
    generated sequence (teacher forcing), within DECODE_LOGIT_TOL of
    max|logits|; the top-2 margin reported wherever the tokens differ."""
    import numpy as np

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon.model_zoo import transformer as tf

    net = decode_net(torch, mx, "float32")
    n_new, rows = 32, 4
    pred = serving.DecodePredictor(
        net, page_size=DECODE_PS, num_pages=rows * DECODE_MAX_PAGES + 1,
        max_seqs=rows, prefill_buckets=DECODE_BUCKETS, kv_dtype="float32")
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, VOCAB, n).tolist() for n in (64, 101, 230, 400)]
    table = np.zeros((rows, pred.max_pages), np.int32)
    held, gen_toks, logits = [], [], []
    for r, p in enumerate(prompts):
        k = -(-(len(p) + n_new) // DECODE_PS)
        pages = pred.pool.alloc(k)
        held += pages
        table[r, :k] = pages
        first, lg = pred.prefill(p, table[r])
        gen_toks.append([first])
        logits.append([lg.float()])
    act = np.ones((rows,), np.int32)
    for i in range(n_new - 1):
        toks = np.asarray([g[-1] for g in gen_toks], np.int32)
        pos = np.asarray([len(p) + i for p in prompts], np.int32)
        nxt, lg = pred.step(toks, pos, act, table)
        for r in range(rows):
            gen_toks[r].append(int(nxt[r]))
            logits[r].append(lg[r].float())
    pred.pool.free(held)
    worst, flips = 0.0, []
    with torch.no_grad():
        cells = pred._cells()
        for r, p in enumerate(prompts):
            seq = torch.tensor([p + gen_toks[r][:-1]], device="cuda")
            flat = tf.flat_forward(cells, pred._spec, seq)[0].float()
            ref = flat[len(p) - 1:]                    # (n_new, vocab)
            got = torch.stack(logits[r])
            err = ((got - ref).abs().max() / ref.abs().max()).item()
            worst = max(worst, err)
            for i in range(n_new):
                want = int(ref[i].argmax())
                if want != gen_toks[r][i]:
                    top2 = ref[i].topk(2).values
                    flips.append({"row": r, "step": i, "paged": gen_toks[r][i],
                                  "flat": want, "top2_margin":
                                  (top2[0] - top2[1]).item()})
    ok = worst <= DECODE_LOGIT_TOL
    log(f"[n] fp32 model, fp32 KV: {rows} prompts ({[len(p) for p in prompts]}"
        f" tokens) x {n_new} greedy tokens, teacher-forced through "
        f"flat_forward: max|logits - flat| / max|flat| {worst:.3g} (limit "
        f"{DECODE_LOGIT_TOL:g}); token disagreements {len(flips)}"
        f"{' ' + str(flips[:4]) if flips else ''} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase n: the paged decode's logits stray from the "
                         "flat forward's")
    del pred, net
    torch.cuda.empty_cache()
    return {"max_rel_err": worst, "flips": flips, "tokens": n_new,
            "prompts": [len(p) for p in prompts]}


def decode_phase(torch, mx, kernels):
    """Phase n: generative decode at GPT-2-small width (bf16 weights) with
    fp32 and int8 KV, then the fp32 teacher-forced check."""
    from mxnet_tpu_torch.ops import decode_attention as da

    net = decode_net(torch, mx, "bfloat16")
    runs = {}
    # each pool twice, in the order A B B A, so that neither gains from
    # going second; the first run of each is the record, the second its
    # "repeat"
    for kv in ("float32", "int8", "int8", "float32"):
        pred, rec = decode_traffic(torch, kernels, da, net, kv)
        want_writes = 0 if kv == "float32" else LAYERS
        want_k4 = 2 * LAYERS
        parts = ("paged_decode_attn", "kv_quantize_write")
        nodes = graph_nodes(pred._execs[("step",)], f"decode_step_{kv}",
                            parts=parts)
        prefill = graph_nodes(pred._execs[("prefill", DECODE_BUCKETS[-1])],
                              f"decode_prefill_{kv}", parts=parts)
        rec["step_graph_nodes"] = nodes
        rec["prefill_graph_nodes"] = prefill
        log(f"[n] kv {kv}: the step's graph: {nodes['kernels']} kernel "
            f"nodes, {nodes['paged_decode_attn']} of them K4's (want "
            f"{want_k4}: splits and combine for each of {LAYERS} layers), "
            f"{nodes['kv_quantize_write']} the int8 write's (want "
            f"{want_writes}); the {DECODE_BUCKETS[-1]}-token prefill's: "
            f"{prefill['kernels']} kernel nodes, "
            f"{prefill['kv_quantize_write']} the int8 write's (want "
            f"{want_writes})")
        if (nodes["paged_decode_attn"] != want_k4
                or nodes["kv_quantize_write"] != want_writes
                or prefill["kv_quantize_write"] != want_writes):
            raise SystemExit("phase n: the step or prefill graph does not "
                             f"hold {want_k4} K4 nodes and {want_writes} "
                             "int8 write nodes")
        rec["step"] = decode_step_profile(torch, pred, kv)
        s = rec["step"]
        log(f"[n] kv {kv}: step ({DECODE_SEQS} live slots at position "
            f"{DECODE_STEP_POSITION}) {s['step_ms']:.3f} ms median (host "
            f"clock, next tokens read back); one step profiled: busy "
            f"{s['busy_ms']:.3f} of {s['wall_ms']:.3f} ms wall, "
            f"{s['launches']} kernels, K4 {s['k4_ms']:.4f} ms "
            f"({s['k4_share']:.1%} of device time), int8 write "
            f"{s['write_ms']:.4f} ms in {s['write_launches']} launches")
        if kv in runs:
            runs[kv]["repeat"] = rec
        else:
            runs[kv] = rec
        del pred
        torch.cuda.empty_cache()
    del net
    torch.cuda.empty_cache()
    order = [runs["float32"], runs["int8"], runs["int8"]["repeat"],
             runs["float32"]["repeat"]]
    log("[n] in the order fp32, int8, int8, fp32: tokens/s " + ", ".join(
        f"{r['tokens_per_s']:.1f}" for r in order) + "; inter-token p50 " +
        ", ".join(f"{r['itl_p50_ms']:.3f}" for r in order) + " ms; the "
        "step's busy time " + ", ".join(
            f"{r['step']['busy_ms']:.3f}" for r in order) + " ms, kernels " +
        ", ".join(str(r["step"]["launches"]) for r in order))
    runs["teacher_forced"] = decode_teacher_forced(torch, mx)
    return runs


# ------------------------------------------------------------------ phase o
# training over several ranks on one card: 4 rank processes over a gloo
# group (one H100 holds one NCCL rank only), the capture kill switch on
# (a CUDA graph cannot hold a host-staged collective)
MR_RANKS = 4
MR_BACKEND = "gloo"
MR_JOIN_S = 900                 # the whole of phase o's rank processes
MR_DIR = os.path.join(ROOT, "_multirank")   # gitignored: references, results
RING_SHAPE = (2, 12, 4096, 64)  # (B, H, T global, D): 1024 rows a rank
# the ring against one K1 / K2 call over the whole sequence, max|a - b| /
# max|ref|: bf16 O and gradients round to 2^-8 at other places (the hops'
# merge and the f32 dq / dk / dv sums are the ring's own), fp32 (3xTF32)
# differs by f32 sums in other orders
RING_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
RING_ROUTE = {"bfloat16": "tc", "float32": "tf32x3"}
# o2 / o3 against the one-rank step on the same batch. In bf16 a gradient
# depends on how the batch is split: LayerNorm's gamma and beta gradients
# are sums over every token that cancel, and each rank (or microbatch)
# rounds its partial sum to bf16. One rank's own step split into 4
# microbatches of 2 rows moves them by 3-6 % of max|grad| at 2 layers and
# T=256 (CPU, bf16), 1e-6 in fp32, and by 15 % at full size (the card,
# PR 13's first phase-o call). So the ranks are held to the one-rank step
# split as they split the batch (microbatches=4: the same 2-row slices),
# where only the fp32 sum's order differs, within phase i's tolerances
# (loss 1e-2, every gradient 5e-2 of its max|grad|; the weights after one
# step within 5e-2 of the largest gradient); and to the unsplit one-rank
# step within 5e-2, or, for a gradient that the split alone moves
# further, MR_SPLIT_FACTOR times that move plus 1e-3 (as phase k holds K3
# to the unfused path's own error).
MR_LOSS_TOL, MR_GRAD_TOL, MR_SPLIT_FACTOR = 1e-2, 5e-2, 2.0
# o4 (sp, ring attention) in fp32 (K1 / K2 on "tf32x3") against the
# one-rank fp32 flash step: loss 1e-5 and every gradient 1e-4 of max|grad|
# (f32 sums in other orders). That is o4's check of the ring LM. In bf16
# the ranks split the sequence, and no one-rank step splits it so; the
# bf16 gate (loss 3e-2, each gradient the unsplit bound above, whose
# allowance comes from the batch split) is advisory: a gross fault fails
# it, but it is loose for the LayerNorm gradients.
SP_LOSS_TOL, SP32_LOSS_TOL, SP32_GRAD_TOL = 3e-2, 1e-5, 1e-4
# o5's running statistics against the one-rank step's, max|a - b| /
# max(1, max|ref|) a tensor (test_torch_parallel.py's scale: a running
# mean starts at 0 and moves by 0.1 of a batch mean, so channels whose
# mean is near 0 hold nothing but rounding). After a step from the same
# state on both sides, both hold the 256-image batch's moments, which
# differ only by the convs' rounding and f32 sums in other orders: within
# MR_BN_TOL, and the loss within phase j's 2^-8. That holds step 1 (from
# the seeded weights). Step 2, taken again from the one-rank step's own
# state after step 1, is held to the same loss bound, and its statistics
# to MR_BN_TOL or, where the one-rank step 2 from that state on the
# batch's rows permuted (the same function summed in another order) moves
# them further, MR_SPLIT_FACTOR times that move plus 1e-3, as o2 is held
# to the unsplit step. A per-rank BatchNorm holds its 64 images' moments
# instead, whose two-class mix differs from the batch's: the same first
# step with the moments left per rank (the control) must miss the
# statistics' bound, and its loss is printed beside phase j's (on the
# CPU, 4 ranks of 8 images at 64x64: the control's loss 2.8e-2 and
# statistics 0.33 off, the synchronized step's 4e-7 and 7.5e-6). Step 2
# run on from the ranks' own step 1 carries step 1's rounding through the
# first update, which at initialization is ill-conditioned (BatchNorm's
# beta gradients cancel); its losses are held to 2^-8, its statistics
# printed beside the witness: the one-rank steps on the batch's rows
# permuted, the same function summed in another order.
MR_BN_TOL = 1e-3


def _trim_qkv_bias(name, g):
    """Without the key third of attn_qkv_bias, whose true gradient is 0
    (phase i)."""
    if name.endswith("attn_qkv_bias"):
        return g[[i for i in range(3 * UNITS)
                  if not UNITS <= i < 2 * UNITS]]
    return g


def _worst_grad(grads, ref):
    """(worst max|a - b| / max|b| over the parameters, its name)."""
    return max((rel_err(_trim_qkv_bias(n, grads[n]),
                        _trim_qkv_bias(n, ref[n].to(grads[n].device))), n)
               for n in ref)


def _mean_grads(tr, x, y, microbatches=1):
    """The trainer's loss and mean gradients ({name: full tensor}) at its
    current parameters, without an update. It runs the step's forward and
    backward, collectives included (every rank calls it), and writes the
    running statistics as a step does."""
    loss, grads = tr._loss_and_mean_grads(x, y, microbatches)
    return loss, tr._full(grads)


def _held_bytes(trainer):
    import torch

    opt = 0
    for v in trainer.opt_state["state"].values():
        for t in ([v] if isinstance(v, torch.Tensor) else list(v)):
            opt += t.numel() * t.element_size()
    return (sum(v.numel() * v.element_size()
                for v in trainer.params.values()), opt)


def _lm_net(torch, mx, impl="flash", mesh=None, remat=None):
    """Phase h's LM at full width and depth, Xavier from generator seed 0
    on the card: the same weights in every process."""
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    gen = torch.Generator(device="cuda").manual_seed(0)
    net = transformer.transformer_lm(
        vocab=VOCAB, units=UNITS, num_heads=HEADS, num_layers=LAYERS,
        max_len=T, impl=impl, mesh=mesh, remat=remat, prefix="tlm_")
    net.initialize(mx.init.Xavier(), generator=gen)
    return net


def _load_after1(torch, tr, after1, aux):
    """``tr`` given the one-rank step's weights, momentum, step count and
    running statistics ``aux`` after step 1."""
    with torch.no_grad():
        for n, p in after1["params"].items():
            tr.params[n].copy_(p)
        for n, m in after1["opt"].items():
            tr.opt_state["state"][n].copy_(m)
        for n, a in aux.items():
            tr.aux[n].copy_(a)
    tr.opt_state["t"] = after1["t"]


def _resnet_net(torch, mx):
    """Phase j's ResNet-50 with phase j's seeded weights, under a fixed
    prefix (an automatic one counts the nets a process built before)."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    gen = torch.Generator(device="cuda").manual_seed(0)
    net = vision.resnet50_v1(layout="NHWC", stem="s2d", classes=1000,
                             prefix="resnet_")
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), generator=gen)
    return net


def _checksum(torch, net):
    return float(sum(p.data().double().sum().item()
                     for p in net._param_objects().values()))


def multirank_references(torch, mx, kernels):
    """The one-rank references of phase o, each run once here, before the
    ranks start, and left in MR_DIR for them: the whole-sequence K1 / K2
    calls of o1 (each rank's rows of them), the one-rank LM step of o2-o4
    (bf16 over fp32 masters, Adam, phase h's batch: loss and gradients at
    the seeded weights, then the weights after one step) and the one-rank
    ResNet-50 steps of o5 (phase j's recipe, 2 steps at 256: losses and
    running statistics, the state after step 1, and the same steps on the
    batch's rows permuted). Returns the whole-sequence calls' device ms."""
    import shutil

    import numpy as np

    shutil.rmtree(MR_DIR, ignore_errors=True)
    os.makedirs(MR_DIR)
    b, h, t, d = RING_SHAPE
    rows = t // MR_RANKS
    whole = {}
    for dtype in ("bfloat16", "float32"):
        for causal in (True, False):
            gen = torch.Generator(device="cuda").manual_seed(13)
            q, k, v, dout = (torch.randn(RING_SHAPE, generator=gen,
                                         device="cuda").to(
                getattr(torch, dtype)) for _ in range(4))
            out, lse = kernels.flash_attention(q, k, v, causal=causal,
                                               return_lse=True)
            dq, dk, dv = kernels.flash_attention_backward(
                q, k, v, out, lse, dout, causal=causal)
            # the plain versions over the whole sequence (f32 inside), the
            # truth both the whole-sequence call and the ring are held to
            p_out, p_lse = kernels.flash_attention_reference(
                q, k, v, causal=causal, return_lse=True)
            p_dq, p_dk, p_dv = kernels.flash_attention_backward_reference(
                q, k, v, p_out, p_lse, dout, causal=causal)
            errs = {"out": rel_err(out, p_out), "lse": rel_err(lse, p_lse),
                    "dq": rel_err(dq, p_dq), "dk": rel_err(dk, p_dk),
                    "dv": rel_err(dv, p_dv)}
            ok = max(errs.values()) <= RING_TOL[dtype]
            log(f"[o] references: the whole-sequence K1 + K2 call at "
                f"{RING_SHAPE}, {dtype} {'causal' if causal else 'full'}, "
                f"against its plain versions: " + ", ".join(
                    f"{n} {e:.2e}" for n, e in errs.items())
                + f" of max|plain| (tol {RING_TOL[dtype]:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"phase o: the whole-sequence {dtype} K1 / "
                                 "K2 call disagrees with its plain versions")
            if causal:
                whole[dtype] = {
                    "k1_ms": device_ms(lambda: kernels.flash_attention(
                        q, k, v, causal=True, return_lse=True)),
                    "k2_ms": device_ms(
                        lambda: kernels.flash_attention_backward(
                            q, k, v, out, lse, dout, causal=True)),
                    "plain_k1_ms": device_ms(
                        lambda: kernels.flash_attention_reference(
                            q, k, v, causal=True, return_lse=True), n=5),
                    "plain_k2_ms": device_ms(
                        lambda: kernels.flash_attention_backward_reference(
                            q, k, v, p_out, p_lse, dout, causal=True), n=5),
                    "sdpa_ms": sdpa_fwd_bwd_ms(torch, q, k, v, dout),
                    "plain_errors": errs}
            full = {"q": q, "k": k, "v": v, "dout": dout, "out": out,
                    "lse": lse, "dq": dq, "dk": dk, "dv": dv,
                    "p_out": p_out, "p_lse": p_lse, "p_dq": p_dq,
                    "p_dk": p_dk, "p_dv": p_dv}
            for r in range(MR_RANKS):
                torch.save({n: x[:, :, r * rows:(r + 1) * rows].contiguous()
                            .cpu() for n, x in full.items()},
                           os.path.join(MR_DIR, f"o1_{dtype}_{causal}_r{r}"
                                                ".pt"))
            del q, k, v, dout, out, lse, dq, dk, dv, full
            del p_out, p_lse, p_dq, p_dk, p_dv
            torch.cuda.empty_cache()
    log(f"[o] references: SDPA forward + backward over the whole "
        f"{RING_SHAPE} causal sequence (the library yardstick of the ring), "
        f"device ms: bf16 {whole['bfloat16']['sdpa_ms']:.4f}, fp32 "
        f"{whole['float32']['sdpa_ms']:.4f}")
    log(f"[o] references: whole-sequence K1 + K2 at {RING_SHAPE}, causal, "
        f"device ms: bf16 {whole['bfloat16']['k1_ms']:.4f} + "
        f"{whole['bfloat16']['k2_ms']:.4f}, fp32 "
        f"{whole['float32']['k1_ms']:.4f} + {whole['float32']['k2_ms']:.4f};"
        f" their plain versions bf16 {whole['bfloat16']['plain_k1_ms']:.4f} "
        f"+ {whole['bfloat16']['plain_k2_ms']:.4f}, fp32 "
        f"{whole['float32']['plain_k1_ms']:.4f} + "
        f"{whole['float32']['plain_k2_ms']:.4f}")

    with kill_switch():
        x, y = lm_batch(torch, BATCH, T, VOCAB)
        ref = {}
        for dtype in ("bfloat16", "float32"):
            net = _lm_net(torch, mx)
            ref["checksum"] = _checksum(torch, net)
            tr = mx.parallel.ShardedTrainer(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                {"learning_rate": LR}, dtype=dtype)
            loss, grads = _mean_grads(tr, x, y)
            ref[dtype] = {"loss": loss.item(),
                          "grads": {n: g.cpu() for n, g in grads.items()}}
            if dtype == "bfloat16":
                # o6's and o7's: the weights after one unsplit step, and a
                # step split into 2 microbatches of 4 rows as {"fsdp": 2}
                # splits the batch, from the seeded weights
                for n_mb in (1, 2):
                    tr_tp = mx.parallel.ShardedTrainer(
                        _lm_net(torch, mx),
                        mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                        {"learning_rate": LR}, dtype=dtype)
                    got = {}
                    if n_mb == 2:
                        loss2, grads2 = _mean_grads(tr_tp, x, y, 2)
                        got = {"loss": loss2.item(),
                               "grads": {n: g.cpu()
                                         for n, g in grads2.items()}}
                        del grads2
                    tr_tp.step(x, y, microbatches=n_mb)
                    got["params"] = {n: p.cpu()
                                     for n, p in tr_tp.params.items()}
                    ref["unsplit" if n_mb == 1 else "split2"] = got
                    del tr_tp, got
                    torch.cuda.empty_cache()
                loss4, grads4 = _mean_grads(tr, x, y, 4)
                split = {n: rel_err(grads4[n], grads[n]) for n in grads}
                tr.step(x, y, microbatches=4)
                ref["split"] = {
                    "loss": loss4.item(), "split_err": split,
                    "grads": {n: g.cpu() for n, g in grads4.items()},
                    "params": {n: p.cpu() for n, p in tr.params.items()}}
                worst = max((v, n) for n, v in split.items())
                log(f"[o] references: the one-rank LM step (B={BATCH}, "
                    f"T={T}, Adam) in bf16: loss {loss.item():.5f}; split "
                    f"into 4 microbatches of {BATCH // 4} rows: loss "
                    f"{loss4.item():.5f}, gradients up to {worst[0]:.2e} of "
                    f"max|grad| from the unsplit step ({worst[1]})")
            else:
                # o6's fp32 weights: one unsplit step from the seeded ones
                tr.step(x, y)
                ref[dtype]["params"] = {n: p.cpu()
                                        for n, p in tr.params.items()}
                log(f"[o] references: the one-rank LM step in fp32: loss "
                    f"{loss.item():.5f}")
            del net, tr, grads
            torch.cuda.empty_cache()
        torch.save(ref, os.path.join(MR_DIR, "lm_ref.pt"))
        del ref

        x, y = imagenet_batch(torch, RESNET_BATCH)
        # the witness: the same two steps on the batch's rows permuted, the
        # same function in another summation order
        perm = torch.from_numpy(np.random.RandomState(5).permutation(
            RESNET_BATCH)).cuda()
        runs = {}
        for name, (xs, ys) in (("ref", (x, y)), ("permuted",
                                                 (x[perm], y[perm]))):
            net = _resnet_net(torch, mx)
            checksum = _checksum(torch, net)
            tr = mx.parallel.ShardedTrainer(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                dict(RESNET_OPT), dtype="bfloat16")
            losses, aux = [], []
            for i in range(2):
                losses.append(tr.step(xs, ys).item())
                aux.append({n: a.to("cpu", copy=True)
                            for n, a in tr.aux.items()})
                if i == 0 and name == "ref":
                    # the state step 2 starts from, for the ranks'
                    # resynchronized step 2
                    after1 = {
                        "params": {n: p.to("cpu", copy=True)
                                   for n, p in tr.params.items()},
                        "opt": {n: m.to("cpu", copy=True) for n, m in
                                tr.opt_state["state"].items()},
                        "t": tr.opt_state["t"]}
            runs[name] = {"checksum": checksum, "losses": losses, "aux": aux}
            del net, tr, xs, ys
            torch.cuda.empty_cache()
        ref, wit = runs["ref"], runs["permuted"]
        # and step 2 on the rows permuted from the unpermuted state after
        # step 1: how far the order alone moves the resynchronized step
        tr = mx.parallel.ShardedTrainer(
            _resnet_net(torch, mx), mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            "sgd", dict(RESNET_OPT), dtype="bfloat16")
        _load_after1(torch, tr, after1, ref["aux"][0])
        wit["losses"].append(tr.step(x[perm], y[perm]).item())
        wit["aux"].append({n: a.to("cpu", copy=True)
                           for n, a in tr.aux.items()})
        del tr
        torch.cuda.empty_cache()
        witness = [{"loss": abs(wit["losses"][i] - ref["losses"][j])
                    / abs(ref["losses"][j]),
                    "stats": max((_stat_err(wit["aux"][i][n],
                                            ref["aux"][j][n]), n)
                                 for n in ref["aux"][j])}
                   for i, j in ((0, 0), (1, 1), (2, 1))]
        torch.save(dict(ref, after1=after1, witness=witness),
                   os.path.join(MR_DIR, "resnet_ref.pt"))
        log(f"[o] references: one-rank ResNet-50 steps (batch "
            f"{RESNET_BATCH}, bf16, SGD): losses {ref['losses']}; the same "
            f"steps on the rows permuted (the witness): losses "
            f"{wit['losses'][:2]}, loss rel {witness[0]['loss']:.2e} / "
            f"{witness[1]['loss']:.2e}, running statistics "
            f"{witness[0]['stats'][0]:.2e} ({witness[0]['stats'][1]}) / "
            f"{witness[1]['stats'][0]:.2e} ({witness[1]['stats'][1]}) of "
            f"max(1, max|ref|) after step 1 / step 2; step 2 on the rows "
            f"permuted from the unpermuted state after step 1: loss rel "
            f"{witness[2]['loss']:.2e}, running statistics "
            f"{witness[2]['stats'][0]:.2e} ({witness[2]['stats'][1]})")
        del x, y, perm, runs, ref, wit, after1
        torch.cuda.empty_cache()
    return whole


def sdpa_fwd_bwd_ms(torch, q, k, v, dout):
    """Device ms of one PyTorch SDPA forward + backward (causal) on q, k, v
    with gradient ``dout``: the one library call that computes what the
    ring's K1 + K2 hops compute together."""
    import torch.nn.functional as F

    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def step():
        qg.grad = kg.grad = vg.grad = None
        F.scaled_dot_product_attention(qg, kg, vg,
                                       is_causal=True).backward(dout)

    return device_ms(step, n=5)


def _ring_alone(torch, kernels, parallel, rank):
    """o1: the ring over {"sp": 4} at RING_SHAPE, bf16 and fp32, causal
    and full, against the whole-sequence calls; then, on rank 0 while the
    others wait, every hop's K1 and K2 of every rank timed alone."""
    import torch.distributed as dist

    from mxnet_tpu_torch.parallel import collectives, ring

    mesh = parallel.create_mesh({"sp": MR_RANKS})
    out = {}
    for dtype in ("bfloat16", "float32"):
        route = RING_ROUTE[dtype]
        for causal in (True, False):
            ref = torch.load(os.path.join(
                MR_DIR, f"o1_{dtype}_{causal}_r{rank}.pt"),
                map_location="cuda")
            q, k, v = (ref[n].clone().requires_grad_() for n in "qkv")
            zero_counts(kernels)
            ring.reset_stats()
            collectives.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o, lse = parallel.ring_attention_inner(
                q, k, v, mesh, "sp", causal=causal, impl="flash",
                return_lse=True)
            o.backward(ref["dout"])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            got = {"out": o, "lse": lse, "dq": q.grad, "dk": k.grad,
                   "dv": v.grad}
            errs = {n: rel_err(g, ref[n]) for n, g in got.items()}
            plain = {n: rel_err(g, ref["p_" + n]) for n, g in got.items()}
            st, cs = ring.stats(), collectives.stats()
            k1 = dict(kernels.flash_attention.launches_by_route)
            k2 = dict(kernels.flash_attention_backward.launches_by_route)
            want = {r: (MR_RANKS if r == route else 0) for r in k1}
            ok = (max(errs.values()) <= RING_TOL[dtype]
                  and max(plain.values()) <= RING_TOL[dtype] and k1 == want
                  and k2 == want and st["k1"]["plain"] == 0
                  and st["k2"]["plain"] == 0)
            log(f"[o1] rank {rank} {dtype} {'causal' if causal else 'full'}"
                f": O {errs['out']:.2e}, lse {errs['lse']:.2e}, dq "
                f"{errs['dq']:.2e}, dk {errs['dk']:.2e}, dv {errs['dv']:.2e}"
                f" of max|whole-sequence call|; O {plain['out']:.2e}, lse "
                f"{plain['lse']:.2e}, dq {plain['dq']:.2e}, dk "
                f"{plain['dk']:.2e}, dv {plain['dv']:.2e} of max|plain "
                f"version| (tol {RING_TOL[dtype]:g} for both); K1"
                f" {k1}, K2 {k2} (want {MR_RANKS} on {route!r}, none plain);"
                f" {wall:.1f} ms wall (host clock); {cs['calls']} "
                f"collectives, {cs['staged_bytes']} bytes staged through "
                f"host buffers in {cs['seconds'] * 1e3:.1f} ms "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"phase o1: rank {rank}'s {dtype} ring "
                                   "disagrees with the whole-sequence call "
                                   "or the plain versions")
            out[f"{dtype}_{'causal' if causal else 'full'}"] = {
                "errors": errs, "plain_errors": plain,
                "k1_launches_by_route": k1,
                "k2_launches_by_route": k2, "wall_ms": wall,
                "collective_calls": cs["calls"],
                "staged_bytes": cs["staged_bytes"],
                "collective_s": cs["seconds"]}
            del q, k, v, o, lse, ref
    dist.barrier()
    if rank == 0:
        out["device_ms"] = _ring_device_ms(torch, kernels)
    dist.barrier()
    return out


def _ring_device_ms(torch, kernels):
    """Every hop's K1 and K2 of every rank, causal, timed alone (device
    time), and the hops' merge: the ring's compute, summed over the ranks
    and for the busiest rank (the last: every hop sees keys)."""
    b, h, t, d = RING_SHAPE
    rows = t // MR_RANKS
    out = {}
    for dtype in ("bfloat16", "float32"):
        parts = [torch.load(os.path.join(MR_DIR, f"o1_{dtype}_True_r{r}.pt"),
                            map_location="cuda") for r in range(MR_RANKS)]
        per_rank = []
        for my in range(MR_RANKS):
            q, o, lse, dout = (parts[my][n] for n in ("q", "out", "lse",
                                                      "dout"))
            ms = 0.0
            for i in range(MR_RANKS):
                src = (my - i) % MR_RANKS
                k, v = parts[src]["k"], parts[src]["v"]
                ms += device_ms(lambda: kernels.flash_attention(
                    q, k, v, causal=True, return_lse=True,
                    q_offset=my * rows, k_offset=src * rows), n=10)
                ms += device_ms(lambda: kernels.flash_attention_backward(
                    q, k, v, o, lse, dout, causal=True, q_offset=my * rows,
                    k_offset=src * rows), n=10)
            per_rank.append(ms)
        out[dtype] = {"total_ms": sum(per_rank), "per_rank_ms": per_rank,
                      "busiest_rank_ms": max(per_rank)}
        del parts
    return out


def _same_on_every_rank(torch, tensors):
    """Whether every rank holds bitwise the same ``tensors`` (a float64
    checksum of their values, gathered)."""
    import torch.distributed as dist

    s = torch.tensor([sum(t.double().sum().item() for t in tensors)],
                     dtype=torch.float64, device="cuda")
    got = [torch.empty_like(s) for _ in range(dist.get_world_size())]
    dist.all_gather(got, s)
    return all(torch.equal(g, got[0]) for g in got)


def _grad_bounds(ref):
    """{name: the bound of a bf16 gradient against a one-rank step}:
    MR_GRAD_TOL or, where the one-rank step's own batch split moves that
    gradient further, MR_SPLIT_FACTOR times that move plus 1e-3."""
    return {n: max(MR_GRAD_TOL, MR_SPLIT_FACTOR * e + 1e-3)
            for n, e in ref["split"]["split_err"].items()}


def _against_bounds(grads, want, bounds):
    """(worst ratio of a gradient's error against ``want`` to its bound,
    the error, the name)."""
    out = []
    for n in grads:
        err = rel_err(_trim_qkv_bias(n, grads[n]),
                      _trim_qkv_bias(n, want[n].cuda()))
        out.append((err / bounds[n], err, n))
    return max(out)


def _against_unsplit(grads, ref):
    """(worst ratio of a gradient's error against the unsplit one-rank
    bf16 step to its bound, the error, the name): :func:`_grad_bounds`."""
    return _against_bounds(grads, ref["bfloat16"]["grads"],
                           _grad_bounds(ref))


def _lm_parallel(torch, mx, kernels, parallel, rank, ref, axes, rules):
    """o2 / o3: the LM over ``axes`` (batch axes: all of them), 2 rows a
    rank: the gradients at the seeded weights and the weights after one
    step against the one-rank step (rank 0 checks; every rank must hold the
    same weights), then steps to 10 timed; the bytes a rank holds."""
    from mxnet_tpu_torch.parallel import collectives

    mesh = parallel.create_mesh(axes)
    net = _lm_net(torch, mx)
    checksum = _checksum(torch, net)
    lay = parallel.SpecLayout.for_mesh(mesh)
    tr = parallel.ShardedTrainer.for_multihost(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": LR}, axes=axes, backend=MR_BACKEND,
        dtype="bfloat16", param_rules=lay.param_rules() if rules else (),
        batch_axis_name=lay.batch_axes())
    x, y = lm_batch(torch, BATCH, T, VOCAB)
    per = BATCH // mesh.size
    me = mesh.axis_index(lay.batch_axes())
    xr, yr = x[me * per:(me + 1) * per], y[me * per:(me + 1) * per]
    # with capture on, a multi-rank step on the card must refuse to run
    # (a CUDA graph cannot hold a host-staged collective), not go eager
    os.environ["MXNET_TPU_TORCH_CAPTURE"] = "1"
    try:
        tr.step(xr, yr)
        refused = "ran"
    except mx.capture.CaptureError as e:
        refused = str(e)
    finally:
        os.environ["MXNET_TPU_TORCH_CAPTURE"] = "0"
    if not refused.startswith("ShardedTrainer: a step over"):
        raise RuntimeError(f"phase o: rank {rank}'s step with capture on "
                           f"did not raise CaptureError ({refused})")
    loss, grads = _mean_grads(tr, xr, yr)
    out = {"loss": loss.item(), "capture_refused": refused}
    if rank == 0:
        split = ref["split"]
        out["loss_rel_err"] = abs(loss.item() - split["loss"]) / abs(
            split["loss"])
        out["worst_grad"] = _worst_grad(grads, split["grads"])
        out["unsplit"] = _against_unsplit(grads, ref)
    del grads
    losses, step_ms, per_step, staged = [], [], [], []
    for i in range(TRAIN_STEPS):
        zero_counts(kernels)
        collectives.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tr.step(xr, yr).item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append((dict(kernels.flash_attention.launches_by_route),
                         dict(kernels.flash_attention_backward
                              .launches_by_route)))
        staged.append(collectives.stats())
        if i == 0:
            full = tr._full(tr.params)
            same = _same_on_every_rank(torch, list(full.values()))
            if rank == 0:
                scale = max(g.abs().max().item()
                            for g in ref["split"]["grads"].values())
                p_err = max((full[n] - ref["split"]["params"][n].cuda())
                            .abs().max().item() for n in full)
            del full
    held = _held_bytes(tr)
    timed = sorted(step_ms[1:])
    median = timed[len(timed) // 2]
    want = {"tc": LAYERS, "tf32x3": 0, "simt": 0}
    drop = losses[0] - losses[-1]
    ok = (checksum == ref["checksum"] and same
          and all(math.isfinite(v) for v in losses) and drop >= 0.5
          and all(a == b == want for a, b in per_step))
    name = "o2" if not rules else "o3"
    if rank == 0:
        ok = ok and (out["loss_rel_err"] <= MR_LOSS_TOL
                     and out["worst_grad"][0] <= MR_GRAD_TOL
                     and out["unsplit"][0] <= 1
                     and p_err <= MR_GRAD_TOL * scale)
        log(f"[{name}] {axes}, {per} rows a rank: loss {loss.item():.5f}; "
            f"against the one-rank step split into the same 2-row slices "
            f"(microbatches=4): loss rel {out['loss_rel_err']:.2e} (tol "
            f"{MR_LOSS_TOL:g}), worst gradient {out['worst_grad'][0]:.2e} "
            f"of max|grad| in {out['worst_grad'][1]} (tol "
            f"{MR_GRAD_TOL:g}), weights after one step max|diff| "
            f"{p_err:.3e} (tol {MR_GRAD_TOL:g} x max|grad| {scale:.3e}); "
            f"against the unsplit one-rank step: at most "
            f"{out['unsplit'][0]:.2f} of the bound ({out['unsplit'][1]:.2e}"
            f" in {out['unsplit'][2]}; bound {MR_GRAD_TOL:g}, or "
            f"{MR_SPLIT_FACTOR:g} x the one-rank split's own move + 1e-3 "
            f"where larger); with capture on the step raised CaptureError: "
            f"{refused!r} {'ok' if ok else 'FAIL'}")
        out.update(param_max_abs_diff=p_err, param_tol=MR_GRAD_TOL * scale)
    log(f"[{name}] rank {rank}: seeded weights equal the reference's "
        f"({checksum == ref['checksum']}), every rank's weights equal after "
        f"a step ({same}); {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (drop {drop:.4f}, want >= 0.5); K1 / K2 a step "
        f"{per_step[-1][0]} / {per_step[-1][1]}; median step {median:.1f} "
        f"ms (host clock; eager: the kill switch; collectives over "
        f"{MR_BACKEND}, which copies CUDA tensors through host memory); a "
        f"step: {staged[-1]['calls']} collectives, {staged[-1]['bytes']} "
        f"bytes, {staged[-1]['staged_bytes']} through host memory, "
        f"{staged[-1]['seconds'] * 1e3:.1f} ms in them; held: parameters "
        f"{held[0]} bytes, optimizer state {held[1]} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"phase {name}: rank {rank} disagrees with the "
                           "one-rank step or failed its checks")
    del tr, net
    torch.cuda.empty_cache()
    out.update(losses=losses, step_ms=step_ms, median_step_ms=median,
               tokens_per_s=BATCH * T / (median / 1e3),
               k1_launches_per_step=per_step[-1][0],
               k2_launches_per_step=per_step[-1][1],
               collectives_per_step=staged[-1], param_bytes=held[0],
               opt_bytes=held[1])
    return out


def _lm_ring(torch, mx, kernels, parallel, rank, ref):
    """o4: TransformerLM(impl='ring') over {"sp": 4}, every row, 256
    tokens a rank, against the one-rank impl='flash' loss and gradients:
    bf16 (route "tc") without remat and with it, then fp32 ("tf32x3")."""
    from mxnet_tpu_torch.parallel import collectives, ring

    mesh = parallel.create_mesh({"sp": MR_RANKS})
    x, y = lm_batch(torch, BATCH, T, VOCAB)
    per = T // MR_RANKS
    xr, yr = x[:, rank * per:(rank + 1) * per], y[:, rank * per:(rank + 1)
                                                   * per]
    out = {}
    for dtype, remat in (("bfloat16", None), ("bfloat16", True),
                         ("float32", None)):
        route = RING_ROUTE[dtype]
        net = _lm_net(torch, mx, impl="ring", mesh=mesh, remat=remat)
        tr = parallel.ShardedTrainer(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
            {"learning_rate": LR}, mesh=mesh, dtype=dtype)
        _mean_grads(tr, xr, yr)           # warm-up
        zero_counts(kernels)
        ring.reset_stats()
        collectives.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = _mean_grads(tr, xr, yr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        k1 = dict(kernels.flash_attention.launches_by_route)
        k2 = dict(kernels.flash_attention_backward.launches_by_route)
        hops = MR_RANKS * LAYERS
        want1 = {r: (hops * (2 if remat else 1) if r == route else 0)
                 for r in k1}
        want2 = {r: (hops if r == route else 0) for r in k2}
        st, cs = ring.stats(), collectives.stats()
        same = _same_on_every_rank(torch, list(grads.values()))
        ok = (k1 == want1 and k2 == want2 and st["k1"]["plain"] == 0
              and st["k2"]["plain"] == 0 and same)
        res = {"loss": loss.item(), "k1_launches_by_route": k1,
               "k2_launches_by_route": k2, "ms": ms, "collectives": cs}
        if rank == 0:
            want = ref[dtype]
            loss_err = abs(loss.item() - want["loss"]) / abs(want["loss"])
            worst = _worst_grad(grads, want["grads"])
            if dtype == "bfloat16":
                unsplit = _against_unsplit(grads, ref)
                ok = ok and loss_err <= SP_LOSS_TOL and unsplit[0] <= 1
                verdict = (f"at most {unsplit[0]:.2f} of the bound, "
                           f"{unsplit[1]:.2e} in {unsplit[2]}: "
                           f"{MR_GRAD_TOL:g}, or {MR_SPLIT_FACTOR:g} x the "
                           "one-rank batch split's own move + 1e-3 where "
                           f"larger; loss tol {SP_LOSS_TOL:g}; advisory: "
                           "the fp32 gate below checks the ring LM")
                res["unsplit"] = unsplit
            else:
                ok = ok and loss_err <= SP32_LOSS_TOL and \
                    worst[0] <= SP32_GRAD_TOL
                verdict = (f"tol {SP32_GRAD_TOL:g}; loss tol "
                           f"{SP32_LOSS_TOL:g}")
            res.update(loss_rel_err=loss_err, worst_grad=worst)
            log(f"[o4] {{'sp': {MR_RANKS}}} impl='ring' {dtype} remat="
                f"{remat}: loss {loss.item():.5f} vs one-rank flash "
                f"{want['loss']:.5f} (rel {loss_err:.2e}); worst gradient "
                f"{worst[0]:.2e} of max|grad| in {worst[1]} ({verdict}) "
                f"{'ok' if ok else 'FAIL'}")
        log(f"[o4] rank {rank} {dtype} remat={remat}: K1 {k1} (want "
            f"{want1}), K2 {k2} (want {want2}); the ranks' gradients equal "
            f"({same}); forward + backward {ms:.1f} ms (host clock, eager); "
            f"{cs['calls']} collectives, {cs['staged_bytes']} bytes through "
            f"host memory, {cs['seconds'] * 1e3:.1f} ms in them "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"phase o4: rank {rank}'s ring LM ({dtype}, "
                               f"remat={remat}) failed its checks")
        out[f"{dtype}{'_remat' if remat else ''}"] = res
        del tr, net, grads
        torch.cuda.empty_cache()
    return out


# o6 / o7 (tensor parallelism) against the one-rank step split as the
# batch is: a row-parallel product is summed over the tp ranks from bf16
# partial products (g), and a column-parallel input's gradient from bf16
# partial gradients (f), where one rank rounds one product. That moves
# the bf16 gradients as a batch split does (the LayerNorm gradients most),
# so each gradient is held to o2's unsplit bound (_grad_bounds), and the
# loss to MR_LOSS_TOL. Adam's first step moves a weight by +-lr by its
# gradient's sign, so the weights after one step are compared where the
# one-rank gradient lies beyond that bound from 0 (the elements whose
# sign the gradient check vouches for), within MR_GRAD_TOL of max|grad|
# as o2's; the rest are counted. The fp32 step (o6) is the check of the
# tp arithmetic: every gradient within SP32_GRAD_TOL of max|grad|, and the
# weights after one step where the one-rank gradient lies beyond that
# bound from 0 within o2's bound. Adam's first step is lr g / (|g| +
# eps / sqrt(1 - beta2)), eps / sqrt(1 - beta2) = 3.2e-7, so a gradient
# near that size moves its step by ~1e-6 when it moves by 1e-6 of
# max|grad| (the chip: 1.5e-6); a misplaced shard or a missing update
# moves a weight by a whole step, lr = 1e-3, far beyond o2's bound.
TP_SHAPE = {"o6": (BATCH, HEADS // 4, T, UNITS // HEADS),
            "o7": (BATCH // 2, HEADS // 2, T, UNITS // HEADS)}


@contextlib.contextmanager
def _tp_launch_shapes(kernels):
    """Within this scope, each K1 and K2 launch appends (kernel, q shape)
    to the yielded list: spies on the launch functions, whose wrappers
    count the launches themselves."""
    shapes = []
    orig = kernels._launch, kernels._launch_bwd

    def k1(q, *args, **kwargs):
        shapes.append(("k1", tuple(q.shape)))
        return orig[0](q, *args, **kwargs)

    def k2(q, *args, **kwargs):
        shapes.append(("k2", tuple(q.shape)))
        return orig[1](q, *args, **kwargs)

    kernels._launch, kernels._launch_bwd = k1, k2
    try:
        yield shapes
    finally:
        kernels._launch, kernels._launch_bwd = orig


def _tp_trainer(torch, mx, parallel, axes, dtype):
    mesh = parallel.create_mesh(axes)
    net = _lm_net(torch, mx)
    lay = parallel.SpecLayout.for_mesh(mesh)
    tr = parallel.ShardedTrainer.for_multihost(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": LR}, axes=axes, backend=MR_BACKEND, dtype=dtype,
        param_rules=lay.param_rules(), batch_axis_name=lay.batch_axes())
    per = BATCH // mesh.axis_size(lay.batch_axes())
    me = mesh.axis_index(lay.batch_axes())
    return net, tr, slice(me * per, (me + 1) * per)


def _sure_weights_err(params, ref_params, ref_grads, bounds):
    """(max|a - b| over the elements of ``params`` whose one-rank gradient
    ``ref_grads`` lies beyond its bound (a share of its max|grad|) from
    0, the count of the other elements)."""
    worst, left = 0.0, 0
    for n, p in params.items():
        g = ref_grads[n].cuda().float().abs()
        sure = g > bounds[n] * g.max()
        left += int(sure.numel() - sure.sum().item())
        if sure.any():
            worst = max(worst, (p.float() - ref_params[n].cuda())[sure]
                        .abs().max().item())
    return worst, left


def _spec_bytes(parallel, mesh, net):
    """The bytes of ``net``'s fp32 parameters that a rank holds under
    SpecLayout's rules on ``mesh``: each dimension a spec names split over
    its axes' ranks (the last piece zero-padded)."""
    rules = [(re.compile(p), s) for p, s in
             parallel.SpecLayout.for_mesh(mesh).param_rules()]
    total = 0
    for name, p in net._param_objects().items():
        shape = list(p.shape)
        spec = next((s for pat, s in rules if pat.match(name)), ())
        for d, e in enumerate(spec):
            if e is not None:
                shape[d] = -(-shape[d] // mesh.axis_size(e))
        total += math.prod(shape) * 4
    return total


def _lm_tp(torch, mx, kernels, parallel, rank, ref, name, axes):
    """o6 / o7: the LM over ``axes`` with SpecLayout's rules, tensor
    parallelism over 'tp' (each rank's heads and FFN columns): the
    gradients at the seeded weights and the weights after one step (and
    after sync_to_net) against the one-rank step split as the batch is
    (rank 0 checks; every rank must hold the same weights), K1 / K2 on
    route "tc" at the tp heads' shape, the tp all-reduces, then steps to
    10 timed; the bytes a rank holds. o6 also checks the fp32 gradients
    (route "tf32x3") against the one-rank fp32 step's."""
    from mxnet_tpu_torch.parallel import collectives

    torch.cuda.reset_peak_memory_stats()
    net, tr, sl = _tp_trainer(torch, mx, parallel, axes, "bfloat16")
    checksum = _checksum(torch, net)
    x, y = lm_batch(torch, BATCH, T, VOCAB)
    xr, yr = x[sl], y[sl]
    rows = xr.shape[0]
    split = ref["unsplit"] if rows == BATCH else ref["split2"]
    want = ref["bfloat16"] if rows == BATCH else split
    loss, grads = _mean_grads(tr, xr, yr)
    out = {"loss": loss.item(), "rows": rows}
    if rank == 0:
        bounds = _grad_bounds(ref)
        out["loss_rel_err"] = abs(loss.item() - want["loss"]) / abs(
            want["loss"])
        out["worst_grad"] = _worst_grad(grads, want["grads"])
        out["bounded"] = _against_bounds(grads, want["grads"], bounds)
        scale = max(g.abs().max().item() for g in want["grads"].values())
    del grads
    losses, step_ms, per_step, stats = [], [], [], []
    with _tp_launch_shapes(kernels) as shapes:
        for i in range(TRAIN_STEPS):
            zero_counts(kernels)
            collectives.reset_stats()
            del shapes[:]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(tr.step(xr, yr).item())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append((dict(kernels.flash_attention.launches_by_route),
                             dict(kernels.flash_attention_backward
                                  .launches_by_route), sorted(set(shapes))))
            stats.append(collectives.stats())
            if i == 0:
                tr.sync_to_net()
                synced = {n: p.data() for n, p in
                          net._param_objects().items()}
                full = tr._full(tr.params)
                same = _same_on_every_rank(torch, list(full.values()))
                if rank == 0:
                    p_err, left = _sure_weights_err(
                        full, split["params"], want["grads"], bounds)
                    s_err, _ = _sure_weights_err(
                        synced, split["params"], want["grads"], bounds)
                del full, synced
    params_b, opt_b = _held_bytes(tr)
    peak = torch.cuda.max_memory_allocated()
    spec_b = _spec_bytes(parallel, tr.mesh, net)
    one_rank = sum(p.data().numel() * 4 for p in net._param_objects()
                   .values())
    timed = sorted(step_ms[1:])
    median = timed[len(timed) // 2]
    want_k = {"tc": LAYERS, "tf32x3": 0, "simt": 0}
    want_shapes = [("k1", TP_SHAPE[name]), ("k2", TP_SHAPE[name])]
    act = rows * T * UNITS * 2            # one bf16 all-reduce's bytes
    want_tp = {"calls": 2 * LAYERS, "bytes": 2 * LAYERS * act}
    tp_ok = all(st["tp"].get(k, {}).get("tp") == want_tp
                for st in stats for k in ("copy_to_tp", "reduce_from_tp"))
    drop = losses[0] - losses[-1]
    share = params_b / one_rank
    ok = (checksum == ref["checksum"] and same and tp_ok
          and all(math.isfinite(v) for v in losses) and drop >= 0.5
          and all(a == b == want_k and c == want_shapes
                  for a, b, c in per_step)
          and params_b == spec_b and opt_b == 2 * params_b)
    if rank == 0:
        ok = ok and (out["loss_rel_err"] <= MR_LOSS_TOL
                     and out["bounded"][0] <= 1
                     and max(p_err, s_err) <= MR_GRAD_TOL * scale)
        against = ("the unsplit one-rank step" if rows == BATCH else
                   "the one-rank step split into 2 microbatches of "
                   f"{rows} rows")
        log(f"[{name}] {axes}, {rows} rows a rank: loss {loss.item():.5f}; "
            f"against {against}: loss rel {out['loss_rel_err']:.2e} (tol "
            f"{MR_LOSS_TOL:g}), worst gradient {out['worst_grad'][0]:.2e} "
            f"of max|grad| in {out['worst_grad'][1]}, at most "
            f"{out['bounded'][0]:.2f} of its bound ({out['bounded'][1]:.2e} "
            f"in {out['bounded'][2]}; bound {MR_GRAD_TOL:g}, or "
            f"{MR_SPLIT_FACTOR:g} x the one-rank split's own move + 1e-3 "
            f"where larger); weights after one step max|diff| {p_err:.3e}, "
            f"the net's after sync_to_net {s_err:.3e} (tol {MR_GRAD_TOL:g} "
            f"x max|grad| {scale:.3e}; {left} of the elements, whose "
            f"one-rank gradient lies within its bound of 0, left out) "
            f"{'ok' if ok else 'FAIL'}")
        out.update(param_max_abs_diff=p_err, synced_max_abs_diff=s_err,
                   param_tol=MR_GRAD_TOL * scale, weights_left_out=left)
    last = stats[-1]
    log(f"[{name}] rank {rank}: seeded weights equal the reference's "
        f"({checksum == ref['checksum']}), every rank's weights equal after "
        f"a step ({same}); {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (drop {drop:.4f}, want >= 0.5); K1 / K2 a step "
        f"{per_step[-1][0]} / {per_step[-1][1]} at {per_step[-1][2]} (want "
        f"{want_k} at {want_shapes}); tp all-reduces a step: {last['tp']} "
        f"(want {want_tp} each); median step {median:.1f} ms (host clock; "
        f"eager; collectives over {MR_BACKEND}, which copies CUDA tensors "
        f"through host memory); a step: {last['calls']} collectives, "
        f"{last['bytes_by_kind']} bytes by kind, {last['staged_bytes']} "
        f"through host memory, {last['seconds'] * 1e3:.1f} ms in them; "
        f"held: parameters {params_b} bytes ({share:.1%} of one rank's "
        f"{one_rank}; the specs' shards: {spec_b}), optimizer state "
        f"{opt_b}; peak allocated {peak / 2 ** 30:.2f} GiB "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"phase {name}: rank {rank} disagrees with the "
                           "one-rank step or failed its checks")
    del tr, net
    torch.cuda.empty_cache()
    out.update(losses=losses, step_ms=step_ms, median_step_ms=median,
               tokens_per_s=BATCH * T / (median / 1e3),
               k1_launches_per_step=per_step[-1][0],
               k2_launches_per_step=per_step[-1][1],
               launch_shapes=per_step[-1][2], collectives_per_step=last,
               param_bytes=params_b, opt_bytes=opt_b,
               one_rank_param_bytes=one_rank, peak_bytes=peak)
    if name == "o6":
        out["float32"] = _lm_tp_fp32(torch, mx, kernels, parallel, rank,
                                     ref, name, axes)
    return out


def _lm_tp_fp32(torch, mx, kernels, parallel, rank, ref, name, axes):
    """o6's fp32 check: the loss and gradients of the fp32 LM over
    ``axes`` (K1 and K2 on route "tf32x3") against the one-rank fp32
    step's, within SP32_LOSS_TOL and SP32_GRAD_TOL; then one step, and the
    net's weights after sync_to_net against the one-rank fp32 step's where
    its gradient lies beyond SP32_GRAD_TOL of max|grad| from 0, within
    MR_GRAD_TOL of max|grad| (o2's bound)."""
    net, tr, sl = _tp_trainer(torch, mx, parallel, axes, None)
    x, y = lm_batch(torch, BATCH, T, VOCAB)
    zero_counts(kernels)
    loss, grads = _mean_grads(tr, x[sl], y[sl])
    k1 = dict(kernels.flash_attention.launches_by_route)
    k2 = dict(kernels.flash_attention_backward.launches_by_route)
    want_k = {"tc": 0, "tf32x3": LAYERS, "simt": 0}
    want = ref["float32"]
    if rank == 0:
        loss_err = abs(loss.item() - want["loss"]) / abs(want["loss"])
        worst = _worst_grad(grads, want["grads"])
    # the full gradients go before the step: 4 ranks and the parent share
    # the card, and an fp32 step at 8 rows of 50257 logits needs ~10 GB
    del grads
    torch.cuda.empty_cache()
    tr.step(x[sl], y[sl])
    tr.sync_to_net()
    ok = k1 == k2 == want_k
    out = {"loss": loss.item(), "k1_launches_by_route": k1,
           "k2_launches_by_route": k2}
    if rank == 0:
        scale = max(g.abs().max().item() for g in want["grads"].values())
        p_err, left = _sure_weights_err(
            {n: p.data() for n, p in net._param_objects().items()},
            want["params"], want["grads"],
            dict.fromkeys(want["grads"], SP32_GRAD_TOL))
        ok = ok and loss_err <= SP32_LOSS_TOL and \
            worst[0] <= SP32_GRAD_TOL and p_err <= MR_GRAD_TOL * scale
        out.update(loss_rel_err=loss_err, worst_grad=worst,
                   param_max_abs_diff=p_err, weights_left_out=left)
        log(f"[{name}] fp32 {axes}: loss {loss.item():.6f} vs one-rank "
            f"{want['loss']:.6f} (rel {loss_err:.2e}, tol "
            f"{SP32_LOSS_TOL:g}); worst gradient {worst[0]:.2e} of "
            f"max|grad| in {worst[1]} (tol {SP32_GRAD_TOL:g}); the net's "
            f"weights after one step and sync_to_net max|diff| {p_err:.3e} "
            f"(tol {MR_GRAD_TOL:g} x max|grad| {scale:.3e}; {left} "
            f"elements, whose one-rank gradient lies within "
            f"{SP32_GRAD_TOL:g} of max|grad| of 0, left out); K1 {k1}, K2 "
            f"{k2} (want {want_k}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"phase {name}: rank {rank}'s fp32 gradients or "
                           "routes failed their check")
    del tr, net
    torch.cuda.empty_cache()
    return out


def _stat_err(got, ref):
    """max|got - ref| / max(1, max|ref|) of a running statistic."""
    ref = ref.to(got.device).float()
    return (got.float() - ref).abs().max().item() / max(
        1.0, ref.abs().max().item())


def _resnet_dp(torch, mx, kernels, parallel, rank, ref):
    """o5: ResNet-50 over {"dp": 4}, 64 images a rank, 2 steps of phase j's
    recipe against the one-rank steps at 256 (BatchNorm's statistics over
    the 256 images); then the control, one step with BatchNorm's moments
    left per rank, which must miss the bounds."""
    from mxnet_tpu_torch.parallel import collectives
    from mxnet_tpu_torch.parallel.functional import functional_call

    mesh = parallel.create_mesh({"dp": MR_RANKS})
    x, y = imagenet_batch(torch, RESNET_BATCH)
    per = RESNET_BATCH // MR_RANKS
    xr, yr = (x[rank * per:(rank + 1) * per].clone(),
              y[rank * per:(rank + 1) * per].clone())
    del x, y

    def trainer():
        net = _resnet_net(torch, mx)
        return net, parallel.ShardedTrainer(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            dict(RESNET_OPT), mesh=mesh, dtype="bfloat16")

    net, tr = trainer()
    checksum = _checksum(torch, net)
    losses, step_ms, bn_err = [], [], []
    for i in range(2):
        collectives.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tr.step(xr, yr).item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        bn_err.append(max((_stat_err(tr.aux[n], ref["aux"][i][n]), n)
                          for n in ref["aux"][i]))
    cs = collectives.stats()
    same = _same_on_every_rank(torch, list(tr.aux.values())
                               + list(tr.params.values()))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                       ref["losses"]))
    # step 2 again, from the one-rank step's own state after step 1
    # (weights, momentum, running statistics): the ranks' step is then
    # held to the same bounds as step 1, without what step 1's rounding
    # did to the first update
    _load_after1(torch, tr, ref["after1"], ref["aux"][0])
    resync_loss = tr.step(xr, yr).item()
    resync = (abs(resync_loss - ref["losses"][1]) / abs(ref["losses"][1]),
              max((_stat_err(tr.aux[n], ref["aux"][1][n]), n)
                  for n in ref["aux"][1]))
    del tr, net
    torch.cuda.empty_cache()
    # the control: the trainer's step with BatchNorm's moments per rank
    net, tr = trainer()
    tr._fwd = functional_call(net, train=True)
    ctl_loss = tr.step(xr, yr).item()
    ctl_err = (abs(ctl_loss - ref["losses"][0]) / abs(ref["losses"][0]),
               max(_stat_err(tr.aux[n], a)
                   for n, a in ref["aux"][0].items()))
    del tr, net
    torch.cuda.empty_cache()
    wit = ref["witness"]
    resync_tol = max(MR_BN_TOL, MR_SPLIT_FACTOR * wit[2]["stats"][0] + 1e-3)
    ok = (loss_err <= RESNET_MB_TOL and bn_err[0][0] <= MR_BN_TOL and same
          and checksum == ref["checksum"] and ctl_err[1] > MR_BN_TOL
          and resync[0] <= RESNET_MB_TOL and resync[1][0] <= resync_tol)
    log(f"[o5] rank {rank} {{'dp': {MR_RANKS}}} ResNet-50 bf16, {per} "
        f"images a rank: losses {losses} vs one-rank at {RESNET_BATCH} "
        f"{ref['losses']} (worst rel {loss_err:.2e}, tol "
        f"{RESNET_MB_TOL:.2e}: phase j's); running statistics worst "
        f"{bn_err[0][0]:.2e} of max(1, max|ref|) after step 1 "
        f"({bn_err[0][1]}; tol {MR_BN_TOL:g}), {bn_err[1][0]:.2e} after "
        f"step 2 ({bn_err[1][1]}; not gated: the one-rank step on its rows "
        f"permuted moves them by {wit[1]['stats'][0]:.2e} "
        f"({wit[1]['stats'][1]}) and its loss by {wit[1]['loss']:.2e}); "
        f"step 2 from the one-rank step's state after step 1: loss rel "
        f"{resync[0]:.2e} (tol {RESNET_MB_TOL:.2e}), running statistics "
        f"{resync[1][0]:.2e} ({resync[1][1]}; tol {resync_tol:.2e}: "
        f"{MR_BN_TOL:g}, or {MR_SPLIT_FACTOR:g} x the "
        f"{wit[2]['stats'][0]:.2e} that the rows' order alone moves the "
        f"one-rank step 2 + 1e-3 where larger); the "
        f"control with per-rank "
        f"BatchNorm: first loss rel {ctl_err[0]:.2e} (phase j's bound "
        f"{'missed' if ctl_err[0] > RESNET_MB_TOL else 'met'}), statistics"
        f" {ctl_err[1]:.2e} (must miss {MR_BN_TOL:g}); every rank the same "
        f"weights "
        f"and statistics ({same}); steps {step_ms[0]:.1f}, "
        f"{step_ms[1]:.1f} ms (host clock, eager); a step: {cs['calls']} "
        f"collectives, {cs['bytes']} bytes, {cs['staged_bytes']} through "
        f"host memory, {cs['seconds'] * 1e3:.1f} ms in them "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"phase o5: rank {rank}'s ResNet-50 steps "
                           "disagree with the one-rank steps, or the "
                           "per-rank control met the bounds")
    return {"losses": losses, "loss_rel_err": loss_err,
            "bn_rel_err": [e[0] for e in bn_err],
            "bn_worst": [e[1] for e in bn_err], "resync_loss": resync_loss,
            "resync_loss_rel_err": resync[0],
            "resync_bn_rel_err": resync[1][0], "resync_bn_tol": resync_tol,
            "witness": wit,
            "control": ctl_err,
            "step_ms": step_ms, "collectives_per_step": cs}


def multirank_rank(rank, world):
    """One rank of phase o (a spawned process): o1-o7 in order, results in
    MR_DIR/rank<r>.json. Any failed check raises, which fails the phase."""
    os.environ["MXNET_TPU_TORCH_CAPTURE"] = "0"
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.ops import kernels

    dist.init_process_group(MR_BACKEND, init_method="file://" + os.path.join(
        MR_DIR, "rendezvous"), world_size=world, rank=rank)
    if rank == 0:
        log(f"[o] {world} ranks on {torch.cuda.get_device_name(0)}: backend "
            f"{dist.get_backend()!r}, MXNET_TPU_TORCH_CAPTURE="
            f"{os.environ['MXNET_TPU_TORCH_CAPTURE']}")
    try:
        res = {"o1": _ring_alone(torch, kernels, parallel, rank)}
        lm_ref = torch.load(os.path.join(MR_DIR, "lm_ref.pt"), mmap=True)
        res["o2"] = _lm_parallel(torch, mx, kernels, parallel, rank, lm_ref,
                                 {"dp": MR_RANKS}, rules=False)
        res["o3"] = _lm_parallel(torch, mx, kernels, parallel, rank, lm_ref,
                                 {"dp": 2, "fsdp": 2}, rules=True)
        res["o4"] = _lm_ring(torch, mx, kernels, parallel, rank, lm_ref)
        res["o6"] = _lm_tp(torch, mx, kernels, parallel, rank, lm_ref, "o6",
                           {"tp": MR_RANKS})
        res["o7"] = _lm_tp(torch, mx, kernels, parallel, rank, lm_ref, "o7",
                           {"fsdp": 2, "tp": 2})
        del lm_ref
        res["o5"] = _resnet_dp(torch, mx, kernels, parallel, rank,
                               torch.load(os.path.join(MR_DIR,
                                                       "resnet_ref.pt"),
                                          mmap=True))
        with open(os.path.join(MR_DIR, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def multirank_phase(torch, mx, kernels):
    """Phase o: the one-rank references here, then MR_RANKS rank processes
    on this card over a gloo group (o1-o7); fails if any rank fails or the
    ranks do not finish within MR_JOIN_S."""
    import gc

    import torch.multiprocessing as mp

    torch.cuda.empty_cache()
    whole = multirank_references(torch, mx, kernels)
    # the ranks share the card with this process: what earlier phases left
    # in reference cycles (graphs, predictors) goes before they start
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[o] the card before the ranks: {free / 2 ** 30:.1f} of "
        f"{total / 2 ** 30:.1f} GiB free; this process holds "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} reserved")
    log(f"[o] spawning {MR_RANKS} rank processes on this card: backend "
        f"{MR_BACKEND!r} (chosen: one H100 holds one NCCL rank), "
        f"MXNET_TPU_TORCH_CAPTURE=0 set for them (a CUDA graph cannot hold "
        f"a host-staged collective)")
    t0 = time.perf_counter()
    ctx = mp.start_processes(multirank_rank, args=(MR_RANKS,),
                             nprocs=MR_RANKS, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + MR_JOIN_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise SystemExit(f"phase o: the ranks did not finish within "
                                 f"{MR_JOIN_S} s")
    except mp.ProcessRaisedException as e:
        raise SystemExit(f"phase o: a rank failed:\n{e}")
    except mp.ProcessExitedException as e:
        raise SystemExit(f"phase o: a rank exited: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(MR_RANKS):
        with open(os.path.join(MR_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    dev = ranks[0]["o1"]["device_ms"]
    b, h, t, d = RING_SHAPE
    (f1, n1), (f2, n2) = (attention_work(b, h, t, d, True, 2),
                          attention_bwd_work(b, h, t, d, True, 2))
    (f1_32, n1_32), (f2_32, n2_32) = (attention_work(b, h, t, d, True, 4),
                                      attention_bwd_work(b, h, t, d, True, 4))
    # the work the ring must do is the whole sequence's: the same visible
    # (query, key) pairs, each input read once, each output written once
    whole["bfloat16"]["bound"] = bound(f1 + f2, n1 + n2)
    whole["float32"]["bound"] = bound_tf32x3(f1_32 + f2_32,
                                             n1_32 + n2_32)[:2]
    for dtype in ("bfloat16", "float32"):
        w = whole[dtype]["k1_ms"] + whole[dtype]["k2_ms"]
        log(f"[o1] the ring's K1 + K2 at {RING_SHAPE} causal, {dtype}, every "
            f"hop timed alone (device time): {dev[dtype]['total_ms']:.4f} ms "
            f"summed over the ranks, busiest rank "
            f"{dev[dtype]['busiest_rank_ms']:.4f}, per rank "
            f"{[round(v, 4) for v in dev[dtype]['per_rank_ms']]}; one "
            f"whole-sequence K1 + K2 {w:.4f} ms, its plain versions "
            f"{whole[dtype]['plain_k1_ms'] + whole[dtype]['plain_k2_ms']:.4f}"
            f" ms; bound "
            f"{whole[dtype]['bound'][0]:.4f} ms ({whole[dtype]['bound'][1]})")
    o2, o3 = ranks[0]["o2"], ranks[0]["o3"]
    log(f"[o3] a {{'dp': 2, 'fsdp': 2}} rank holds "
        f"{o3['param_bytes'] / o2['param_bytes']:.1%} of a {{'dp': 4}} "
        f"rank's parameter bytes and {o3['opt_bytes'] / o2['opt_bytes']:.1%}"
        f" of its optimizer state")
    o6, o7 = ranks[0]["o6"], ranks[0]["o7"]
    for name, o, axes in (("o6", o6, "{'tp': 4}"),
                          ("o7", o7, "{'fsdp': 2, 'tp': 2}")):
        tp_bytes = sum(a["bytes"] for kind in o["collectives_per_step"][
            "tp"].values() for a in kind.values())
        log(f"[{name}] a {axes} rank holds "
            f"{o['param_bytes'] / o2['param_bytes']:.1%} of a {{'dp': 4}} "
            f"rank's parameter bytes; median step {o['median_step_ms']:.1f} "
            f"ms beside o2's {o2['median_step_ms']:.1f} and o3's "
            f"{o3['median_step_ms']:.1f} (eager, gloo); tp all-reduces "
            f"{tp_bytes} bytes a step")
    log(f"[o] {MR_RANKS} ranks finished o1-o7 in {wall:.1f} s")
    import shutil

    shutil.rmtree(MR_DIR, ignore_errors=True)
    return {"backend": MR_BACKEND, "ranks": MR_RANKS, "wall_s": wall,
            "whole_sequence_ms": whole, "per_rank": ranks}


# ------------------------------------------------------- K5 and phase p
# ResNet-18 v1's convolutions at 224^2 (NCHW): (Cin, Cout, H = W in, kernel,
# stride, pad, how many of the 20), and its FC 512 -> 1000
R18_CONVS = ((3, 64, 224, 7, 2, 3, 1), (64, 64, 56, 3, 1, 1, 4),
             (64, 128, 56, 3, 2, 1, 1), (128, 128, 28, 3, 1, 1, 3),
             (64, 128, 56, 1, 2, 0, 1), (128, 256, 28, 3, 2, 1, 1),
             (256, 256, 14, 3, 1, 1, 3), (128, 256, 28, 1, 2, 0, 1),
             (256, 512, 14, 3, 2, 1, 1), (512, 512, 7, 3, 1, 1, 3),
             (256, 512, 14, 1, 2, 0, 1))
R18_FC = (512, 1000)
K5_CHECK_N = 8
INT8_BUCKETS = (1, 32, 128)
INT8_CALIB = 32            # calibration images, batches of 16
INT8_TOL = 0.15            # of max|fp32|, and top-1 agreement >= 0.75
INT8_AGREE = 0.75          #   (mxnet_tpu's tests/test_int8_e2e.py:74-77)
INT8_PREDICTS = 20         # timed predicts a dtype at bucket 128
INT8_OPS = {"_contrib_quantize_v2": 1, "_contrib_quantized_conv": 20,
            "_contrib_quantized_act": 17, "_contrib_quantized_pooling": 2,
            "_contrib_quantized_elemwise_add": 8,
            "_contrib_quantized_fully_connected": 1,
            "_contrib_requantize": 36, "_contrib_dequantize": 1}


@contextlib.contextmanager
def exact_f64_convs(torch):
    """The plain versions' float64 convs, exact on integers, through
    PyTorch's own im2col + DGEMM: cuDNN's algorithms (FFT, Winograd) may
    round, so it is off inside."""
    with torch.backends.cudnn.flags(enabled=False):
        yield


def s8_rand(torch, gen, shape, lo=-127, hi=128, offset=0):
    """Seeded int8 values in [lo, hi); ``offset`` bytes into a larger
    buffer (a misaligned base)."""
    n = 1
    for s in shape:
        n *= s
    buf = torch.randint(lo, hi, (n + offset,), generator=gen, device="cuda",
                        dtype=torch.int8)
    return buf[offset:].view(shape)


def k5_zero_counts(q):
    for fn in (q.s8_conv, q.s8_matmul, q.requant_epilogue,
               q.s8_conv_requant):
        fn.launches = 0
        for by in ("launches_by_route", "launches_by_mode"):
            for key in getattr(fn, by, {}):
                getattr(fn, by)[key] = 0


def k5_counts(q):
    return {"s8_conv": q.s8_conv.launches, "s8_matmul": q.s8_matmul.launches,
            "requant_int8": q.requant_epilogue.launches,
            "s8_conv_requant": q.s8_conv_requant.launches,
            "conv_by_route": dict(q.s8_conv.launches_by_route),
            "matmul_by_route": dict(q.s8_matmul.launches_by_route),
            "requant_by_path": dict(q.requant_epilogue.launches_by_route),
            "requant_by_mode": dict(q.requant_epilogue.launches_by_mode),
            "fused_by_mode": dict(q.s8_conv_requant.launches_by_mode)}


K5_ROUTES = ("wgmma", "mma_s8")


@contextlib.contextmanager
def k5_route(q, route):
    """While open, K5's route rule names ``route`` for every conv and GEMM
    (the wrappers call ``q._s8_route``)."""
    saved = q._s8_route
    q._s8_route = lambda *args, **kwargs: route
    try:
        yield
    finally:
        q._s8_route = saved


@contextlib.contextmanager
def k5_plain_guard(q):
    """While open, K5's plain versions raise on a CUDA tensor: the
    wrappers must launch their kernels for those."""
    names = ("s8_conv_reference", "s8_matmul_reference",
             "requant_epilogue_reference", "requant_range_reference",
             "s8_conv_requant_reference")
    saved = [getattr(q, name) for name in names]

    def guarded(fn):
        def call(data, *args, **kwargs):
            if data.is_cuda:
                raise SystemExit(f"a CUDA tensor reached {fn.__name__}")
            return fn(data, *args, **kwargs)
        return call

    for name, fn in zip(names, saved):
        setattr(q, name, guarded(fn))
    try:
        yield
    finally:
        for name, fn in zip(names, saved):
            setattr(q, name, fn)


def check_k5(torch, q):
    """Phase b for K5: csrc/s8_gemm_wgmma.cu (route "wgmma") and
    csrc/s8_gemm.cu (route "mma_s8"), the route forced, on ResNet-18's 11
    conv shapes (its 20 convs) at N=8 with an int32 bias and on the edges
    (Cin 5 with K off a multiple of 32, odd H and W, dilation 2, a ragged M,
    misaligned bases, no bias), NHWC convs on "wgmma" (channels read in
    place and folded), the wgmma route's pre-pass bitwise equal to its
    plain version; the GEMM on the FC (8 x 512 -> 1000) and on ragged rows
    on both routes, on K off a multiple of 16 and misaligned bases on
    "mma_s8", the rule's route: int32 exactly equal to the float64 plain
    versions, a second launch bitwise equal. csrc/requant_int8.cu on both
    paths bitwise equal to its plain version, on the int32 grid's whole
    range and on exact .5 ties; a NaN range comes out NaN. Grouped int8
    convs on CUDA must raise. Prints the wgmma kernels' ptxas registers,
    shared memory and spills first."""
    from mxnet_tpu_torch.ops import _build

    lib = _build.load("s8_gemm_wgmma")
    lib.s8_wgmma_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.s8_wgmma_smem_bytes.restype = ctypes.c_int
    for entry, usage in ptxas_usage(_build.build_log("s8_gemm_wgmma")):
        log(f"[b] ptxas {entry}: {usage}")
    log("[b] s8_wgmma_kernel dynamic shared memory a CTA (the ring; a "
        "resident A tile adds its bytes): " + ", ".join(
            f"{w} warpgroups x {cb} B loads {lib.s8_wgmma_smem_bytes(w, cb)}"
            for w in (1, 2) for cb in (16, 32, 64, 128)))
    gen = torch.Generator(device="cuda").manual_seed(61)
    records = []
    conv_cases = [(f"r18 {c[0]}->{c[1]} {c[2]}^2 k{c[3]} s{c[4]} p{c[5]}",
                   K5_CHECK_N, c[0], c[1], c[2], c[2], c[3], c[4], c[5], 1,
                   True, 0) for c in R18_CONVS]
    conv_cases += [
        ("Cin 5 odd 13x11 k3 s1 p1 (K=45)", 3, 5, 24, 13, 11, 3, 1, 1, 1,
         True, 0),
        ("dilation 2 k3 p2 odd 15x17", 2, 16, 40, 15, 17, 3, 1, 2, 2, True,
         0),
        ("ragged M 1x9x7 k3 s2 p0, no bias", 1, 32, 70, 9, 7, 3, 2, 0, 1,
         False, 0),
        ("misaligned bases k1 s1", 3, 48, 64, 10, 10, 1, 1, 0, 1, True, 3),
    ]
    for (name, n, cin, cout, h, w, k, s, p, dil, with_bias,
         off) in conv_cases:
        x = s8_rand(torch, gen, (n, cin, h, w), offset=off)
        wt = s8_rand(torch, gen, (cout, cin, k, k), offset=off)
        bias = (torch.randint(-2 ** 20, 2 ** 20, (cout,), generator=gen,
                              device="cuda", dtype=torch.int32)
                if with_bias else None)
        args = ((s, s), (p, p), (dil, dil))
        rule = q._s8_route("conv", kernel=(k, k), stride=args[0],
                           pad=args[1], dilate=args[2])
        with exact_f64_convs(torch):
            want = q.s8_conv_reference(x, wt, *args, bias=bias)
        for route in K5_ROUTES:
            before = dict(q.s8_conv.launches_by_route)
            with k5_plain_guard(q), k5_route(q, route):
                got = q.s8_conv(x, wt, *args, bias=bias)
                again = q.s8_conv(x, wt, *args, bias=bias)
            torch.cuda.synchronize()
            same = torch.equal(got, want) and got.dtype == torch.int32
            repeat = torch.equal(got, again)
            launched = q.s8_conv.launches_by_route[route] - before[route]
            ok = same and repeat and launched == 2 and rule == "wgmma"
            log(f"[b] s8_conv [{route}] {name} N={n}: int32 == plain (f64) "
                f"exactly: {same}; second launch bitwise: {repeat}; "
                f"launches on the route {launched} (want 2); the rule's "
                f"route {rule} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"phase b: s8_conv [{route}] {name} "
                                 "disagrees")
            records.append({"case": f"s8_conv [{route}] {name}",
                            "exact": same, "max_abs_err": int_err(
                                torch, got, want)})
        shape = q._conv_shape(x, wt, *args, False)
        xp, wp, pk = q._s8_conv_prepare(x, wt, shape)
        rx, rw = q.s8_conv_pack_reference(x, wt, *args)
        torch.cuda.synchronize()
        packed = torch.equal(xp, rx) and torch.equal(wp, rw)
        log(f"[b] s8_wgmma_prep {name}: x {tuple(xp.shape)} and w "
            f"{tuple(wp.shape)} (fold {pk.fold}) bitwise == plain: {packed} "
            f"{'ok' if packed else 'FAIL'}")
        if not packed:
            raise SystemExit(f"phase b: the wgmma pre-pass of {name} "
                             "differs from its plain version")
    for name, n, c, cout, h, w, k, s, p, dil in (
            ("NHWC 64 ch (read in place) k3 s1 p1", 2, 64, 96, 9, 9, 3, 1, 1,
             1),
            ("NHWC 5 ch (folded) k3 s2 p1 odd 9x11", 2, 5, 24, 9, 11, 3, 2, 1,
             1),
            ("NHWC 16 ch dilation 2 k3 p2", 2, 16, 64, 10, 12, 3, 1, 2, 2)):
        x = s8_rand(torch, gen, (n, h, w, c))
        wt = s8_rand(torch, gen, (cout, k, k, c))
        bias = torch.randint(-2 ** 20, 2 ** 20, (cout,), generator=gen,
                             device="cuda", dtype=torch.int32)
        args = ((s, s), (p, p), (dil, dil))
        with exact_f64_convs(torch):
            want = q.s8_conv_reference(x, wt, *args, layout="NHWC",
                                       bias=bias)
        before = q.s8_conv.launches_by_route["wgmma"]
        with k5_plain_guard(q):
            got = q.s8_conv(x, wt, *args, layout="NHWC", bias=bias)
            again = q.s8_conv(x, wt, *args, layout="NHWC", bias=bias)
        torch.cuda.synchronize()
        same, repeat = torch.equal(got, want), torch.equal(got, again)
        launched = q.s8_conv.launches_by_route["wgmma"] - before
        ok = same and repeat and launched == 2
        log(f"[b] s8_conv [wgmma] {name}: int32 == plain (f64) exactly: "
            f"{same}; second launch bitwise: {repeat}; launches {launched} "
            f"(want 2) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase b: s8_conv {name} disagrees")
        records.append({"case": f"s8_conv [wgmma] {name}", "exact": same,
                        "max_abs_err": int_err(torch, got, want)})
    for name, m, k, n, off in (("r18 FC", K5_CHECK_N, *R18_FC, 0),
                               ("ragged rows 77x48 -> 70", 77, 48, 70, 0),
                               ("ragged K 77x45 -> 70", 77, 45, 70, 0),
                               ("misaligned 33x64 -> 96", 33, 64, 96, 5)):
        x = s8_rand(torch, gen, (m, k), offset=off)
        wt = s8_rand(torch, gen, (n, k), offset=off)
        bias = torch.randint(-2 ** 20, 2 ** 20, (n,), generator=gen,
                             device="cuda", dtype=torch.int32)
        want = q.s8_matmul_reference(x, wt) + bias
        rule = q._s8_route("matmul", k=k, ptrs=(x.data_ptr(), wt.data_ptr()))
        for route in K5_ROUTES if rule == "wgmma" else (rule,):
            before = dict(q.s8_matmul.launches_by_route)
            with k5_plain_guard(q), k5_route(q, route):
                got = q.s8_matmul(x, wt, bias=bias)
                again = q.s8_matmul(x, wt, bias=bias)
            torch.cuda.synchronize()
            same, repeat = torch.equal(got, want), torch.equal(got, again)
            launched = q.s8_matmul.launches_by_route[route] - before[route]
            ok = same and repeat and launched == 2
            log(f"[b] s8_matmul [{route}] {name} (the rule's route {rule})"
                f": int32 == plain (f64) exactly: {same}; second launch "
                f"bitwise: {repeat} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"phase b: s8_matmul [{route}] {name} "
                                 "disagrees")
            records.append({"case": f"s8_matmul [{route}] {name}",
                            "exact": same, "max_abs_err": int_err(
                                torch, got, want)})
    f32 = dict(dtype=torch.float32, device="cuda")
    full = torch.randint(-2 ** 31, 2 ** 31 - 1, (8, 64, 56, 57),
                         generator=gen, device="cuda", dtype=torch.int32)
    small = (torch.randn((4, 128, 28, 28), generator=gen, device="cuda")
             * 3e6).to(torch.int32)
    # real_in 2^31 makes each int32 x exactly x * 127 / 254 = x / 2 on the
    # via_fp32 path: every odd x is a .5 tie
    ties = torch.arange(-4001, 4002, device="cuda", dtype=torch.int32)
    for name, x, rin, lo, hi in (
            ("int32 range", full, 37.5, -3.25, 2.0),
            ("conv-like", small, 1.7e4, -9.0, 11.5),
            ("exact .5 ties", ties, 2.0 ** 31, -254.0, 254.0),
            ("odd length", small.reshape(-1)[3:100004], 1.7e4, -9.0,
             11.5)):
        for path in ("via_fp32", "fused_scale"):
            args = (torch.tensor(rin, **f32), torch.tensor(lo, **f32),
                    torch.tensor(hi, **f32))
            with k5_plain_guard(q):
                got, glo, ghi = q.requant_epilogue(x, *args, path=path)
                again = q.requant_epilogue(x, *args, path=path)[0]
            want, wlo, whi = q.requant_epilogue_reference(x, *args,
                                                          path=path)
            torch.cuda.synchronize()
            same = (torch.equal(got, want) and torch.equal(glo, wlo)
                    and torch.equal(ghi, whi))
            repeat = torch.equal(got, again)
            ok = same and repeat
            log(f"[b] requant_int8 {path} {name} ({x.numel()} values): "
                f"int8 and range == plain bitwise: {same}; second launch "
                f"bitwise: {repeat} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"phase b: requant_int8 {path} {name} "
                                 "disagrees")
            records.append({"case": f"requant_int8 {path} {name}",
                            "bitwise": same, "max_abs_err": (
                                got.float() - want.float()).abs().max()
                            .item()})
    nan = torch.tensor(float("nan"), **f32)
    _, nlo, nhi = q.requant_epilogue(small, torch.tensor(1.7e4, **f32),
                                     torch.tensor(-9.0, **f32), nan)
    poisoned = bool(torch.isnan(nlo) and torch.isnan(nhi))
    log(f"[b] requant_int8 with a NaN range: output range NaN: {poisoned} "
        f"{'ok' if poisoned else 'FAIL'}")
    if not poisoned:
        raise SystemExit("phase b: requant_int8 drops the NaN poison")
    relu_d = small.clamp_min(0)
    for name, x, rin in (("int32 range", full, 37.5),
                         ("conv-like", small, 1.7e4),
                         ("relu'd, half zeros", relu_d, 1.7e4),
                         ("all zeros", torch.zeros_like(small), 1.7e4),
                         ("odd length", small.reshape(-1)[3:100004], 1.7e4),
                         ("NaN real_in", small, float("nan"))):
        records += check_requant_batch_range(torch, q, name, x,
                                             torch.tensor(rin, **f32))
    records += check_conv_requant(torch, q, gen)
    x = s8_rand(torch, gen, (2, 8, 9, 9))
    try:
        q.s8_conv(x, s8_rand(torch, gen, (8, 4, 3, 3)), (1, 1), (1, 1),
                  (1, 1), num_group=2)
    except Exception as e:   # noqa: BLE001 - the raise is the check
        log(f"[b] s8_conv grouped on CUDA raises: "
            f"{type(e).__name__}: {str(e)[:90]} ok")
    else:
        raise SystemExit("phase b: a grouped int8 conv on CUDA did not "
                         "raise")
    return records


def same_bits(torch, a, b):
    """Bitwise equal, a NaN anywhere matching a NaN (the card's NaN bits
    and the CPU's differ)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        return bool(torch.equal(na, nb)) and bool(torch.equal(a[~na],
                                                              b[~nb]))
    return bool(torch.equal(a, b))


def check_requant_batch_range(torch, q, name, x, real_in):
    """csrc/requant_int8.cu without a calibrated range, on ``x``: mode
    "own" (the kernel's range pass) and mode "given" (the plain range
    handed in as a producer's word) against the plain versions:
    requant_range_reference's range bitwise (NaN as NaN), the int8 output
    bitwise where the range is finite."""
    rng = q.requant_range_reference(x, real_in)
    want = q.requant_epilogue_reference(x, real_in, -rng, rng)
    finite = bool(torch.isfinite(rng))
    out = []
    for mode, amax in (("own", None), ("given", rng.clone())):
        before = q.requant_epilogue.launches_by_mode[mode]
        with k5_plain_guard(q):
            got = q.requant_epilogue(x, real_in, amax=amax)
            again = q.requant_epilogue(x, real_in, amax=amax)[0]
        torch.cuda.synchronize()
        ranges = same_bits(torch, got[1], want[1]) and \
            same_bits(torch, got[2], want[2])
        same = ranges and (not finite or torch.equal(got[0], want[0]))
        repeat = torch.equal(got[0], again)
        launched = q.requant_epilogue.launches_by_mode[mode] - before
        ok = same and repeat and launched == 2
        log(f"[b] requant_int8 batch range ({mode}) {name} ({x.numel()} "
            f"values): range {got[2].item():.6g} == plain bitwise: {ranges}"
            f"; int8 == plain bitwise{'' if finite else ' (not compared: '
                                         'NaN range)'}: {same}; second "
            f"launch bitwise: {repeat} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase b: requant_int8 batch range ({mode}) "
                             f"{name} disagrees")
        out.append({"case": f"requant_int8 {mode} range {name}",
                    "bitwise": same, "max_abs_err": 0 if same else None})
    return out


def check_conv_requant(torch, q, gen):
    """s8_wgmma_conv's fused epilogues (s8_conv_requant) against the plain
    chain s8_conv_reference -> relu -> requant_epilogue_reference (mode
    "requant": int8 and range bitwise) or -> requant_range_reference (mode
    "range": int32 exactly, the range word bitwise), relu on and off, on
    every store path: even NCHW planes, odd planes, NHWC; the NaN poison
    in both modes (a NaN calibrated range, a NaN real_in)."""
    f32 = dict(dtype=torch.float32, device="cuda")
    out = []
    for name, n, c, cout, h, k, s, p, layout in (
            ("even planes 64->64 56^2 k3", 4, 64, 64, 56, 3, 1, 1, None),
            ("even planes 64->128 56^2 k1 s2", 4, 64, 128, 56, 1, 2, 0,
             None),
            ("odd planes 256->512 14^2 k3 s2", 4, 256, 512, 14, 3, 2, 1,
             None),
            ("odd planes 32->96 9^2 k3 (ragged Cout)", 3, 32, 96, 9, 3, 1,
             1, None),
            ("NHWC 64->64 10^2 k3", 2, 64, 64, 10, 3, 1, 1, "NHWC")):
        shape = (n, h, h, c) if layout else (n, c, h, h)
        wshape = (cout, k, k, c) if layout else (cout, c, k, k)
        x, w = s8_rand(torch, gen, shape), s8_rand(torch, gen, wshape)
        bias = torch.randint(-2 ** 16, 2 ** 16, (cout,), generator=gen,
                             device="cuda", dtype=torch.int32)
        args = (x, w, (s, s), (p, p), (1, 1), layout, bias)
        # the int32 sums' spread is ~127^2 / 3 sqrt(K): a grid on which
        # it reads ~2, so the range (-3, 2.5) clips its tails only
        real_in = torch.tensor(2.0 ** 31 * 2.0 / (5376.0 * (c * k * k)
                                                  ** 0.5), **f32)
        for relu in (False, True):
            for mode, lo, hi in (("requant", -3.0, 2.5), ("range", 0, 0),
                                 ("requant", -3.0, float("nan")),
                                 ("range", None, None)):
                scal = {"real_in": real_in}
                if mode == "requant":
                    scal.update(out_min=torch.tensor(lo, **f32),
                                out_max=torch.tensor(hi, **f32))
                elif lo is None:
                    scal["real_in"] = torch.tensor(float("nan"), **f32)
                with exact_f64_convs(torch):
                    want = q.s8_conv_requant_reference(*args, relu=relu,
                                                       **scal)
                before = q.s8_conv_requant.launches_by_mode[mode]
                with k5_plain_guard(q):
                    got = q.s8_conv_requant(*args, relu=relu, **scal)
                torch.cuda.synchronize()
                launched = q.s8_conv_requant.launches_by_mode[mode] - before
                poison = hi != hi or lo is None
                if mode == "requant":
                    ranges = same_bits(torch, got[1], want[1]) and \
                        same_bits(torch, got[2], want[2])
                    same = ranges and (poison or torch.equal(got[0],
                                                             want[0]))
                    err = 0 if poison else int_err(torch, got[0], want[0])
                else:
                    same = torch.equal(got[0], want[0]) and \
                        same_bits(torch, got[1], want[1])
                    err = int_err(torch, got[0], want[0])
                ok = same and launched == 1 and (
                    not poison or bool(torch.isnan(got[-1])))
                what = f"{mode}{' NaN poison' if poison else ''}"
                log(f"[b] s8_conv_requant [{what}] {name} relu {relu}: "
                    f"== plain chain bitwise: {same} (max |diff| {err}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"phase b: s8_conv_requant [{what}] "
                                     f"{name} disagrees")
                out.append({"case": f"s8_conv_requant [{what}] {name} "
                                    f"relu {relu}", "bitwise": same,
                            "max_abs_err": err})
    return out


INT8_DIR = os.path.join(ROOT, "_int8")   # gitignored: the exported model


def int8_images(n, seed):
    """n seeded 224^2 images, NCHW float32 (numpy): per image and channel a
    random level plus a random sinusoidal grating, plus 10 % uniform noise.
    A randomly initialized ResNet averages i.i.d. pixel noise away, so
    uniform-noise images all land on one class; gratings spread the
    logits over several classes, which gives the top-1 agreement between
    int8 and fp32 something to measure."""
    import numpy as np

    rng = np.random.RandomState(seed)
    axis = np.linspace(0, 1, 224, dtype=np.float32)
    yy, xx = np.meshgrid(axis, axis, indexing="ij")
    out = np.empty((n, 3, 224, 224), np.float32)
    for i in range(n):
        for c in range(3):
            level, amp, fy, fx, phase = rng.rand(5)
            out[i, c] = level + amp * np.sin(
                2 * np.pi * (8 * fy * yy + 8 * fx * xx + phase))
    return out + 0.1 * rng.rand(n, 3, 224, 224).astype(np.float32)


def host_ms(torch, fn, n):
    """Host-clock ms of each of ``n`` calls of ``fn``, each ended by a
    synchronise."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def int8_serving(torch, mx, q):
    """Phase p: INT8 serving of ResNet-18 v1 (224^2 NCHW, 1000 classes,
    seeded Xavier) through the entry points a user calls: export, a
    Predictor built from the exported files with quantize="int8" (BatchNorm
    folded, naive calibration on 32 images, the full-int8 graph), buckets
    (1, 32, 128), each one CUDA graph. The executor's plan must fuse 8
    conv -> relu -> calibrated requantize chains (s8_conv_requant mode
    "requant") and 11 conv -> batch-range requantize chains (mode "range",
    then requant_int8 reading the conv's range word). K5's counts are
    zeroed just before the Predictor is built and read after the first
    predict: per bucket program 1 conv, 19 fused convs (8 + 11), 1 FC and
    28 requantize launches (12 calibrated, 11 given a range, 5 computing
    their own), on the kernels (every conv and the FC on route "wgmma"),
    none on "mma_s8" or plain. Checks the graph's op counts and the
    bucket-128 graph's kernel nodes, the captured predict's logits bitwise
    against the unfused walk's, int8 against the folded fp32 graph on 128
    other images (within 0.15 max|fp32|, top-1 agreement >= 0.75), bitwise
    replay and padding, and the bucket-128 logits bitwise against a
    Predictor of the same files and calibration table built and run with
    the route rule patched to "mma_s8" (which fuses nothing); times img/s
    at bucket 128 for fp32 (the Symbol-fed Predictor), bf16 (the Block-fed
    one) and int8, p50 per bucket, and profiles one int8 predict."""
    import collections
    import shutil

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.contrib import quantization as cq
    from mxnet_tpu_torch.gluon.model_zoo import vision

    os.makedirs(INT8_DIR, exist_ok=True)
    net = vision.resnet18_v1(classes=1000)
    net.initialize(mx.init.Xavier(),
                   generator=torch.Generator(device="cuda").manual_seed(0))
    sym_file, params_file = net.export(os.path.join(INT8_DIR, "resnet18_v1"))
    calib_x = int8_images(INT8_CALIB, 1)
    x = torch.from_numpy(int8_images(128, 2)).cuda()
    tail = {"data": (3, 224, 224)}

    k5_zero_counts(q)
    t0 = time.perf_counter()
    with k5_plain_guard(q):
        pred8 = serving.Predictor(
            sym_file, params_file, input_shapes=tail,
            batch_sizes=INT8_BUCKETS, quantize="int8",
            calib_data=mx.io.NDArrayIter(calib_x, batch_size=16),
            calib_mode="naive")
        out8 = pred8.predict(x)[0]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = k5_counts(q)
    programs = 3 * len(INT8_BUCKETS)   # 2 warm-up runs + the capture each
    chains = collections.Counter(c[3] for c in pred8._graph.fused_chains)
    uncal = sum(n.op == "_contrib_requantize" and
                "min_calib_range" not in n.params
                for n in pred8._symbol._topo_nodes())
    per = {"s8_conv": 20 - 19, "s8_conv_requant": 19, "s8_matmul": 1,
           "requant_int8": 36 - 8}
    want = {k: v * programs for k, v in per.items()}
    want_modes = {"calibrated": (36 - uncal - 8) * programs,
                  "given": 11 * programs, "own": (uncal - 11) * programs}
    ops = collections.Counter(n.op for n in pred8._symbol._topo_nodes()
                              if not n.is_var)
    ok = all(counts[k] == v for k, v in want.items()) and \
        dict(chains) == {"requant": 8, "range": 11} and \
        dict(ops) == INT8_OPS and counts["requant_by_path"]["fused_scale"] \
        == 0 and counts["requant_by_mode"] == want_modes and \
        counts["fused_by_mode"] == {"requant": 8 * programs,
                                    "range": 11 * programs} and \
        counts["conv_by_route"] == {"wgmma": programs, "mma_s8": 0} and \
        counts["matmul_by_route"] == {"wgmma": programs, "mma_s8": 0}
    log(f"[p] resnet18_v1 exported ({sum(t.numel() for t in net.collect_params().values())} "
        f"parameters), Predictor(quantize='int8', naive calibration on "
        f"{INT8_CALIB} images) built and buckets {INT8_BUCKETS} captured "
        f"in {build_s:.2f} s; graph ops {dict(ops)}; fused chains "
        f"{dict(chains)} (want 8 requant, 11 range); K5 launches "
        f"{counts} over {programs} bucket programs (want {want}, "
        f"requantize by mode {want_modes}: per predict 1 conv, 19 fused "
        f"convs, 1 FC, 28 requantize; every conv and the FC on route "
        f"wgmma, none on mma_s8), none plain {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase p: the int8 graph or K5's launches are not "
                         "what the path must run")
    # the captured fused predict against the unfused walk (a tap walks the
    # unfused nodes), eager, on the same feeds: bitwise
    values = dict(pred8._arg_params, **pred8._aux_params)
    values[pred8.input_names[0]] = x
    with torch.inference_mode():
        walk = pred8._graph.run([values[n] for n in pred8._arg_names],
                                [values[n] for n in pred8._aux_names],
                                tap=lambda *a: None)[0][0]
    torch.cuda.synchronize()
    unfused_same = bool(torch.equal(walk, out8))
    log(f"[p] the captured fused bucket-128 predict's logits bitwise equal "
        f"to the unfused walk's: {unfused_same} "
        f"{'ok' if unfused_same else 'FAIL'}")
    if not unfused_same:
        raise SystemExit("phase p: the fused predict differs from the "
                         "unfused walk")
    del walk, values

    # the folded fp32 graph, the int8 graph's truth
    fsym, fargs, fauxs = cq.fold_batch_norm(
        pred8._fp32_state[0], pred8._fp32_state[1], pred8._fp32_state[2])
    ex = fsym.bind(mx.gpu(0), {**fargs, "data": x}, aux_states=fauxs)
    ref = ex.forward()[0]
    err = ((out8 - ref).abs().max() / ref.abs().max()).item()
    agree = (out8.argmax(1) == ref.argmax(1)).float().mean().item()
    finite = bool(torch.isfinite(out8).all())
    ok = finite and err <= INT8_TOL and agree >= INT8_AGREE and \
        tuple(out8.shape) == (128, 1000)
    log(f"[p] int8 logits against the folded fp32 graph on 128 other "
        f"images: max|int8 - fp32| {err:.4e} of max|fp32| (tol "
        f"{INT8_TOL}), top-1 agreement {agree:.3f} (>= {INT8_AGREE}), "
        f"{len(set(ref.argmax(1).tolist()))} distinct fp32 classes, finite "
        f"{finite} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase p: int8 logits are off the fp32 graph's")
    again = pred8.predict(x)[0]
    replay = torch.equal(again, out8)
    # 16 of the 36 requantize steps (the residual adds' int32 operands,
    # mxnet_tpu's '<name>_rq') have no calibrated range and take the
    # batch's own: a row's answer moves with the rows beside it
    pad = pred8.predict(x[:3])[0]
    row32 = pred8.predict(x[:32])[0][:3]
    batch_dep = ((pad - row32).abs().max() / row32.abs().max()).item()
    log(f"[p] a second predict bitwise equal: {replay} "
        f"{'ok' if replay else 'FAIL'}; 3 rows padded to bucket 32 against "
        f"those rows of a full bucket-32 predict: {batch_dep:.3e} of max "
        f"(not gated: {uncal} requantize steps take the batch's range)")
    if not replay:
        raise SystemExit("phase p: int8 predict does not replay bitwise")
    nodes = graph_nodes(pred8._exec, "int8_bucket128",
                        parts=("s8_wgmma_kernel", "s8_prep_kernel",
                               "s8_gemm_kernel", "requant_kernel",
                               "requant_range_kernel"),
                        sig=next(s for s in pred8._exec.compiled_signatures
                                 if s[0][0][0] == 128))
    log(f"[p] the bucket-128 int8 graph: {nodes['kernels']} kernel nodes, "
        f"{nodes['s8_wgmma_kernel']} s8_wgmma (want 21: 1 conv, 19 fused, "
        f"the FC), {nodes['s8_prep_kernel']} pre-pass (want 20), "
        f"{nodes['s8_gemm_kernel']} s8_gemm (want 0), "
        f"{nodes['requant_kernel']} requant (want 28), "
        f"{nodes['requant_range_kernel']} requant range passes (want "
        f"{uncal - 11})")
    if (nodes["s8_wgmma_kernel"], nodes["s8_prep_kernel"],
            nodes["s8_gemm_kernel"], nodes["requant_kernel"],
            nodes["requant_range_kernel"]) != (21, 20, 0, 28, uncal - 11):
        raise SystemExit("phase p: the captured int8 graph does not hold "
                         "K5's kernels")
    # the same predict with every conv and the FC on csrc/s8_gemm.cu: both
    # routes are exact, so the logits must be bitwise equal
    before = k5_counts(q)
    with k5_plain_guard(q), k5_route(q, "mma_s8"):
        pred_m = serving.Predictor(
            sym_file, params_file, input_shapes=tail, batch_sizes=(128,),
            quantize="int8", calib_table=pred8.calibration_table)
        out_m = pred_m.predict(x)[0]
    torch.cuda.synchronize()
    after = k5_counts(q)
    moved = {r: after["conv_by_route"][r] - before["conv_by_route"][r]
             for r in K5_ROUTES}
    fused_m = after["s8_conv_requant"] - before["s8_conv_requant"]
    routes_same = bool(torch.equal(out_m, out8))
    log(f"[p] bucket-128 int8 logits with the route rule patched to mma_s8 "
        f"(conv launches by route {moved}, fused {fused_m}: the plan fuses "
        f"no mma_s8 conv) bitwise equal to the wgmma route's fused "
        f"predict: {routes_same} {'ok' if routes_same else 'FAIL'}")
    if not routes_same or moved["wgmma"] or not moved["mma_s8"] or \
            fused_m or pred_m._graph.fused_chains:
        raise SystemExit("phase p: the int8 logits differ between K5's "
                         "routes")
    del pred_m, out_m

    pred32 = serving.Predictor(sym_file, params_file, input_shapes=tail,
                               batch_sizes=INT8_BUCKETS)
    out32 = pred32.predict(x)[0]
    fold_err = ((out32 - ref).abs().max() / ref.abs().max()).item()
    net.cast("bfloat16")
    pred16 = serving.Predictor.from_block(net, input_shapes=tail,
                                          batch_sizes=INT8_BUCKETS,
                                          dtype="bfloat16")
    out16 = pred16.predict(x)[0].float()
    bf16_err = ((out16 - out32).abs().max() / out32.abs().max()).item()
    log(f"[p] fp32 Symbol-fed Predictor against the folded graph "
        f"{fold_err:.2e} of max|fp32|; bf16 Block-fed Predictor against fp32 "
        f"{bf16_err:.2e}")
    timing = {}
    for label, pred in (("fp32", pred32), ("bf16", pred16),
                        ("int8", pred8)):
        ms = host_ms(torch, lambda: pred.predict(x), INT8_PREDICTS)
        p50 = {}
        for b in INT8_BUCKETS:
            lat = sorted(host_ms(torch, lambda: pred.predict(x[:b]), 11))
            p50[b] = lat[len(lat) // 2]
        timing[label] = {"images_per_s": 128e3 * len(ms) / sum(ms),
                         "predict128_ms": sorted(ms)[len(ms) // 2],
                         "p50_ms": p50}
        log(f"[p] {label}: {timing[label]['images_per_s']:.1f} images/s at "
            f"bucket 128 ({INT8_PREDICTS} predicts, host clock, median "
            f"{timing[label]['predict128_ms']:.3f} ms); p50 ms per bucket "
            + ", ".join(f"{b}: {v:.3f}" for b, v in p50.items()))
    breakdown = profile_window(torch, lambda: pred8.predict(x),
                               "one bucket-128 int8 predict", "p",
                               ("s8_wgmma_kernel", "s8_prep_kernel",
                                "requant_kernel", "requant_range_kernel"),
                               top=12)
    groups = {"convs + FC (s8_wgmma)": 0.0, "their pre-pass (s8_prep)": 0.0,
              "requantize": 0.0, "other quantized ops": 0.0}
    for r in breakdown["all"]:
        key = ("convs + FC (s8_wgmma)" if "s8_wgmma_kernel" in r["kernel"]
               else "their pre-pass (s8_prep)" if "s8_prep_kernel" in
               r["kernel"] else "requantize" if "requant_kernel" in
               r["kernel"] or "requant_range_kernel" in r["kernel"]
               else "other quantized ops")
        groups[key] += r["ms"]
    log("[p] device ms of one int8 predict: " + ", ".join(
        f"{k} {v:.3f}" for k, v in groups.items()) +
        f"; busy {breakdown['device_busy_ms']:.3f} ms")
    del pred32, pred16, net, ex
    torch.cuda.empty_cache()
    shutil.rmtree(INT8_DIR, ignore_errors=True)
    return {"build_s": build_s, "launches": counts,
            "launches_per_predict": {k: v / programs for k, v in
                                     counts.items() if k in want},
            "graph_ops": dict(ops), "graph_nodes": nodes,
            "max_rel_err": err, "top1_agreement": agree,
            "routes_bitwise": routes_same, "unfused_bitwise": unfused_same,
            "fused_chains": dict(chains),
            "uncalibrated_requantize": uncal, "batch_dependence": batch_dep,
            "fold_err": fold_err, "bf16_err": bf16_err, "timing": timing,
            "breakdown": breakdown, "device_ms_groups": groups,
            "predictor": pred8, "x": x}


K5_NODE_OPS = {"_contrib_quantized_conv": "conv",
               "_contrib_quantized_fully_connected": "fc",
               "_contrib_requantize": "requant"}


def k5_path(torch, q, pred8, x):
    """K5's calls on the main path: one eager walk of the bucket-128 int8
    graph that each bucket captures, on the same feeds, through the
    executor's tap (the unfused nodes). Returns {"conv" | "fc" | "requant":
    [(inputs by the op function's parameter names, the node's outputs)]}
    in graph order, and "chains": [(the conv's inputs and parameters by
    name, relu, the requantize's calibrated range as keywords, the conv's
    outputs, the requantize's outputs, "requant" or "range")] for each
    chain the executor's plan fuses."""
    import inspect

    from mxnet_tpu_torch.ops import registry

    outs = {}

    def tap(node, i, t):
        outs[(id(node), i)] = t

    values = dict(pred8._arg_params, **pred8._aux_params)
    values[pred8.input_names[0]] = x
    with torch.inference_mode():
        pred8._graph.run([values[n] for n in pred8._arg_names],
                         [values[n] for n in pred8._aux_names], tap=tap)
    torch.cuda.synchronize()
    calls = {"conv": [], "fc": [], "requant": [], "chains": []}

    def bound_args(n):
        op = registry.get_op(n.op)
        ins = [values[i.name] if i.is_var else outs[(id(i), s)]
               for i, s in n.inputs]
        bound = inspect.signature(op.fn).bind(*ins, **op.normalize(n.params))
        bound.apply_defaults()
        return op, dict(bound.arguments)

    for n in pred8._symbol._topo_nodes():
        if n.is_var or registry.get_op(n.op).name not in K5_NODE_OPS:
            continue
        op, args = bound_args(n)
        calls[K5_NODE_OPS[op.name]].append((
            args, [outs[(id(n), i)] for i in range(op.num_outputs)]))
    for conv, act, rq, mode in pred8._graph.fused_chains:
        calib = {k: rq.params[k] for k in ("min_calib_range",
                                           "max_calib_range")
                 if rq.params.get(k) is not None}
        calls["chains"].append((
            bound_args(conv)[1], act is not None, calib,
            [outs[(id(conv), i)] for i in range(3)],
            [outs[(id(rq), i)] for i in range(3)], mode))
    return calls


def k5_conv_args(q, a):
    """(data, weight, stride, pad, dilate, int32 bias) of a quantized conv
    node's call of s8_conv, from its inputs and parameters."""
    sdims = a["data"].dim() - 2
    b = q._s8s8_bias(a["bias"], a["min_data"], a["max_data"],
                     a["min_weight"], a["max_weight"], a["min_bias"],
                     a["max_bias"], a["no_bias"])[2]
    return (a["data"], a["weight"], q._pairs(a["stride"] or 1, sdims),
            q._pairs(a["pad"] or 0, sdims), q._pairs(a["dilate"] or 1, sdims),
            b)


def k5_fc_args(q, a):
    """(x, weight, int32 bias) of a quantized FC node's call of
    s8_matmul."""
    d = a["data"]
    x = d.reshape(d.shape[0], -1) if a["flatten"] and d.dim() > 2 else d
    b = q._s8s8_bias(a["bias"], a["min_data"], a["max_data"],
                     a["min_weight"], a["max_weight"], a["min_bias"],
                     a["max_bias"], a["no_bias"])[2]
    return x, a["weight"], b


def k5_requant_args(q, a):
    """(data, real_in, out_min, out_max) of a requantize node's call of
    requant_epilogue; out_min and out_max None where it takes the batch's
    range."""
    return (a["data"], *q._requant_ranges(
        a["min_range"], a["max_range"], a["min_calib_range"],
        a["max_calib_range"]))


def requant_plain(q, d, real_in, lo, hi):
    """The plain versions of a requantize step: under (lo, hi), or without
    them under requant_range_reference's batch range."""
    if lo is None:
        hi = q.requant_range_reference(d, real_in)
        lo = -hi
    return q.requant_epilogue_reference(d, real_in, lo, hi)


def chain_conv_args(q, a, relu, calib):
    """(s8_conv_requant's positional arguments, its scalars as keywords)
    of a fused chain from its conv's inputs and parameters, as
    quantized_conv_requantize makes them."""
    *args, b = k5_conv_args(q, a)
    lo, hi, _ = q._s8s8_bias(a["bias"], a["min_data"], a["max_data"],
                             a["min_weight"], a["max_weight"], a["min_bias"],
                             a["max_bias"], a["no_bias"])
    real_in, out_min, out_max = q._requant_ranges(
        lo, hi, calib.get("min_calib_range"), calib.get("max_calib_range"))
    scal = {"real_in": real_in, "relu": relu}
    if out_min is not None:
        scal.update(out_min=out_min, out_max=out_max)
    return (*args, a["layout"], b), scal


def int_err(torch, got, want):
    """max |got - want| over int tensors, exactly (as int64)."""
    return (got.long() - want.long()).abs().max().item()


def check_k5_path(torch, q, calls):
    """Each K5 call of one bucket-128 predict, held to its plain version
    on the inputs the path gave it: every conv's and the FC's int32 output
    exactly equal to the float64 plain version with the same int32 bias,
    every requantize's int8 output and range bitwise equal. Returns the
    largest |kernel - plain| of each."""
    errs = {}
    for kind, plain in (("conv", q.s8_conv_reference),
                        ("fc", q.s8_matmul_reference)):
        worst = 0
        for a, res in calls[kind]:
            if kind == "conv":
                *args, b = k5_conv_args(q, a)
                with exact_f64_convs(torch):
                    ref = plain(*args, bias=b)
            else:
                xx, w, b = k5_fc_args(q, a)
                ref = plain(xx, w)
                ref = ref if b is None else ref + b
            err = int_err(torch, res[0], ref)
            if err or res[0].dtype != torch.int32 or \
                    res[0].shape != ref.shape:
                raise SystemExit(
                    f"phase c: K5 {kind} on the path's inputs "
                    f"{tuple(a['data'].shape)} differs from its plain "
                    f"version (max |diff| {err})")
            worst = max(worst, err)
            del ref
        errs[kind] = worst
        log(f"[c] K5 {kind}: the {len(calls[kind])} calls of one bucket-128 "
            f"predict, on the path's own inputs, exactly equal (int32) to "
            f"the float64 plain version ok")
    for a, res in calls["requant"]:
        d, real_in, lo, hi = k5_requant_args(q, a)
        ref = requant_plain(q, d, real_in, lo, hi)
        same = all(same_bits(torch, g, w) for g, w in zip(res, ref))
        if not same:
            raise SystemExit(
                f"phase c: K5 requantize on the path's {tuple(d.shape)} "
                f"input differs from its plain version (max |diff| "
                f"{int_err(torch, res[0], ref[0])})")
    errs["requant"] = 0
    log(f"[c] K5 requantize: the {len(calls['requant'])} calls of the "
        "unfused walk of one bucket-128 predict (calibrated, or computing "
        "the batch range), on the path's own inputs, bitwise equal to the "
        "plain version (int8 and range) ok")
    given = fused = 0
    for a, relu, calib, conv_out, rq_out, mode in calls["chains"]:
        args, scal = chain_conv_args(q, a, relu, calib)
        with k5_plain_guard(q):
            got = q.quantized_conv_requantize(**a, relu=relu, **calib)
            direct = q.s8_conv_requant(*args, **scal)
        torch.cuda.synchronize()
        same = all(same_bits(torch, g, w) for g, w in zip(got, rq_out))
        d = conv_out[0].clamp_min(0) if relu else conv_out[0]
        if mode == "requant":
            with exact_f64_convs(torch):
                plain = q.s8_conv_requant_reference(
                    *args, **{k: (v.reshape(()) if torch.is_tensor(v)
                                  else v) for k, v in scal.items()})
            same = same and all(same_bits(torch, g, w)
                                for g, w in zip(direct, plain))
            fused += same
        else:
            word = q.requant_range_reference(d, scal["real_in"])
            same = same and torch.equal(direct[0], d) and \
                same_bits(torch, direct[1], word)
            with k5_plain_guard(q):
                alone = q.requant_epilogue(direct[0], scal["real_in"],
                                           amax=direct[1])
            torch.cuda.synchronize()
            same = same and all(same_bits(torch, g, w)
                                for g, w in zip(alone, rq_out))
            given += same
        if not same:
            raise SystemExit(
                f"phase c: the fused conv ({mode}) on the path's "
                f"{tuple(a['data'].shape)} input differs from its plain "
                "chain")
    errs["chains"] = 0
    log(f"[c] K5 fused convs on the path's own inputs: {fused} of the 8 "
        f"mode-requant calls bitwise equal to the plain chain (conv, relu, "
        f"requantize: int8 and range); {given} of the 11 mode-range calls' "
        f"int32 exactly and range words bitwise equal to the plain "
        f"version, and the requantize reading each word (mode given) "
        f"bitwise equal to the unfused walk's ok")
    if (fused, given) != (8, 11):
        raise SystemExit("phase c: the plan's fused calls are not 8 + 11")
    return errs


def int8_bound(ops, nbytes):
    """(bound ms, 'bytes' or 'operations') at the H100's int8 tensor-core
    peak and memory rate."""
    t_ops = ops / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations"


def time_k5(torch, q, pred8, x):
    """Phase c for K5 at the main path's calls (bucket 128): each call held
    to its plain version on the path's own inputs (:func:`check_k5_path`);
    then, on those inputs, each distinct conv, the FC and each requantize
    shape timed: the kernel (device time) beside its bound (int8
    operations at 1,979 TOP/s, or bytes: each input read once, each output
    written once), its plain version (float64), and the library:
    torch._int_mm on the same GEMM (a conv's im2col'd matrix, K padded to a
    multiple of 8: the GEMM alone) and cuDNN's bf16 conv on the same shape;
    requantize has no one-call PyTorch counterpart. A conv and the FC are
    timed on route "wgmma" (the path's: a conv's whole call, and its
    pre-pass and product apart) and "mma_s8" on the same inputs, in turns
    (wgmma, mma_s8, wgmma, mma_s8; each the mean of its two)."""
    import torch.nn.functional as F

    calls = k5_path(torch, q, pred8, x)
    errs = check_k5_path(torch, q, calls)
    convs = {}
    for a, _ in calls["conv"]:
        args = k5_conv_args(q, a)
        key = (tuple(args[0].shape), tuple(args[1].shape)) + args[2:5]
        convs.setdefault(key, [args, 0])[1] += 1
    rows = []
    for (xs, ws, st, pd, dl), ((a, w, _, _, _, bias), count) in \
            convs.items():
        cout, k = ws[0], ws[1] * ws[2] * ws[3]
        ho = (xs[2] + 2 * pd[0] - dl[0] * (ws[2] - 1) - 1) // st[0] + 1
        wo = (xs[3] + 2 * pd[1] - dl[1] * (ws[3] - 1) - 1) // st[1] + 1
        m = xs[0] * ho * wo
        ops = 2.0 * m * cout * k
        nbytes = a.numel() + w.numel() + 4.0 * m * cout + 4.0 * cout
        bound_ms, bound_by = int8_bound(ops, nbytes)
        turns = {r: [] for r in K5_ROUTES}
        for route in K5_ROUTES * 2:
            with k5_route(q, route):
                turns[route].append(device_ms(
                    lambda: q.s8_conv(a, w, st, pd, dl, bias=bias), n=10))
        ms, mma_ms = (sum(turns[r]) / 2 for r in K5_ROUTES)
        shape = q._conv_shape(a, w, st, pd, dl, False)
        xp, wp, pk = q._s8_conv_prepare(a, w, shape)
        prep_ms = device_ms(lambda: q._s8_conv_prepare(a, w, shape), n=10)
        product_ms = device_ms(lambda: q._s8_conv_product(
            xp, wp, pk, bias, shape), n=10)
        del xp, wp
        with exact_f64_convs(torch):
            plain_ms = device_ms(lambda: q.s8_conv_reference(
                a, w, st, pd, dl, bias=bias), n=2)
        kp = -(-k // 8) * 8
        cols = F.unfold(a.half(), ws[2:], dilation=dl, padding=pd,
                        stride=st).transpose(1, 2).reshape(m, k)
        cols = F.pad(cols, (0, kp - k)).to(torch.int8).contiguous()
        wk = F.pad(w.reshape(cout, k), (0, kp - k)).contiguous()
        int_mm_ms = library_ms(lambda: torch._int_mm(cols, wk.t()),
                               "torch._int_mm")
        ab, wb = a.bfloat16(), w.bfloat16()
        cudnn_ms = device_ms(lambda: F.conv2d(ab, wb, None, st, pd, dl),
                             n=10)
        del cols, wk, ab, wb
        rows.append({"shape": [list(xs), list(ws), list(st), list(pd)],
                     "count": count, "ms": ms, "turns": turns,
                     "prep_ms": prep_ms, "product_ms": product_ms,
                     "prep_share": prep_ms / ms, "mma_s8_ms": mma_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "of_bound": bound_ms / ms,
                     "ops": ops, "bytes": nbytes, "int_mm_ms": int_mm_ms,
                     "cudnn_bf16_ms": cudnn_ms, "fold": pk.fold,
                     "tops": ops / ms / 1e9})
        vs = (f"{ms / int_mm_ms:.2f}x torch._int_mm {int_mm_ms:.4f} ms"
              if int_mm_ms else "torch._int_mm not measured")
        log(f"[c] s8_conv x{count} {xs} * {ws} s{st[0]} p{pd[0]}: wgmma "
            f"{ms:.4f} ms device ({ops / ms / 1e9:.1f} TOP/s, "
            f"{bound_ms / ms:.1%} of bound {bound_ms:.4f} ms, {bound_by}; "
            f"pre-pass {prep_ms:.4f} = {prep_ms / ms:.1%}, product "
            f"{product_ms:.4f}), mma_s8 {mma_ms:.4f} ms, {vs}, cuDNN bf16 "
            f"conv {cudnn_ms:.4f} ms, plain (f64) {plain_ms:.3f} ms")
        torch.cuda.empty_cache()
    (fa, _), = calls["fc"]
    a, w, bias = k5_fc_args(q, fa)
    xs, ws = tuple(a.shape), tuple(w.shape)
    ops = 2.0 * xs[0] * ws[0] * ws[1]
    nbytes = a.numel() + w.numel() + 4.0 * xs[0] * ws[0] + 4.0 * ws[0]
    fc_bound = int8_bound(ops, nbytes)
    turns = {r: [] for r in K5_ROUTES}
    for route in K5_ROUTES * 2:
        with k5_route(q, route):
            turns[route].append(device_ms(
                lambda: q.s8_matmul(a, w, bias=bias), n=20))
    fc = {"shape": [list(xs), list(ws)], "count": len(calls["fc"]),
          "ms": sum(turns["wgmma"]) / 2,
          "mma_s8_ms": sum(turns["mma_s8"]) / 2, "turns": turns,
          "plain_ms": device_ms(lambda: q.s8_matmul_reference(a, w), n=5),
          "bound_ms": fc_bound[0], "bound_by": fc_bound[1],
          "library_ms": library_ms(lambda: torch._int_mm(a, w.t()),
                                   "torch._int_mm")}
    log(f"[c] s8_matmul {xs} x {ws}^T: wgmma {fc['ms']:.4f} ms device"
        + (f" ({fc['ms'] / fc['library_ms']:.3f}x torch._int_mm "
           f"{fc['library_ms']:.4f} ms)" if fc["library_ms"] else
           ", torch._int_mm not measured")
        + f", mma_s8 {fc['mma_s8_ms']:.4f} ms, bound "
        f"{fc['bound_ms']:.5f} ms ({fc['bound_by']}), plain (f64) "
        f"{fc['plain_ms']:.4f} ms")
    req = time_requant(torch, q, calls)
    fused = time_fused(torch, q, calls)
    conv = {k: (None if any(r[k] is None for r in rows) else
                sum(r[k] * r["count"] for r in rows))
            for k in ("ms", "plain_ms", "bound_ms", "ops", "bytes",
                      "int_mm_ms", "cudnn_bf16_ms", "mma_s8_ms", "prep_ms",
                      "product_ms")}
    conv["bound_by"] = ("bytes" if conv["bytes"] / PEAK_BYTES
                        >= conv["ops"] / PEAK_INT8_OPS else "operations")
    conv["calls"] = len(calls["conv"])
    conv["per_shape"] = rows
    log(f"[c] s8_conv over the {conv['calls']} convs of one bucket-128 "
        f"predict: wgmma {conv['ms']:.4f} ms device (pre-pass "
        f"{conv['prep_ms']:.4f}, product {conv['product_ms']:.4f}), bound "
        f"{conv['bound_ms']:.4f} ms ({conv['bound_by']}: "
        f"{conv['ops'] / 1e9:.1f} GOP, {conv['bytes'] / 1e9:.3f} GB), "
        f"{conv['bound_ms'] / conv['ms']:.1%} of bound; mma_s8 "
        f"{conv['mma_s8_ms']:.4f} ms; plain {conv['plain_ms']:.3f} ms; "
        f"torch._int_mm {conv['int_mm_ms']} ms, cuDNN bf16 "
        f"{conv['cudnn_bf16_ms']:.4f} ms")
    slower = [r["shape"] for r in rows
              if r["shape"][1][2] == 3 and r["int_mm_ms"] is not None
              and r["ms"] > r["int_mm_ms"]]
    log(f"[c] 3x3 shapes slower on wgmma than their own torch._int_mm: "
        f"{len(slower)} of {sum(r['shape'][1][2] == 3 for r in rows)} "
        f"{slower}")
    return {"conv": conv, "fc": fc, "requant": req, "fused": fused,
            "path_errs": errs,
            "path_calls": {k: len(v) for k, v in calls.items()}}


RQ_SWEEP = ("random int32", "zeros 0 % (+-3e6)", "zeros 50 % (relu'd)",
            "zeros 90 %", "zeros 100 %", "small (|x| < 128)")


def rq_sweep_input(torch, gen, shape, kind):
    """int32 of ``shape`` for requantize's value sweep (RQ_SWEEP)."""
    if kind == "random int32":
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             device="cuda", dtype=torch.int32)
    if kind == "small (|x| < 128)":
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int32)
    x = torch.randint(-3 * 10 ** 6, 3 * 10 ** 6, shape, generator=gen,
                      device="cuda", dtype=torch.int32)
    share = {"zeros 0 % (+-3e6)": 0.0, "zeros 50 % (relu'd)": None,
             "zeros 90 %": 0.9, "zeros 100 %": 1.0}[kind]
    if share is None:
        return x.clamp_min(0)
    keep = torch.rand(shape, generator=gen, device="cuda") >= share
    return x * keep


def time_requant(torch, q, calls):
    """The standalone requantize steps of the fused predict (28 of the 36:
    the 8 calibrated ones after a conv and relu run in the conv's
    epilogue), each in its mode -- calibrated, given (the 11 after a conv,
    reading its range word), own (the 5 after an add or a pool, computing
    the batch range) -- on the path's own inputs and on random int32 of
    the same shapes and modes: device ms beside the bound (bytes: each
    input read once, each output written once; mode own's second read of x
    counted apart as the bytes it moves), the plain versions' time; and
    the value sweep (RQ_SWEEP) at the largest shape, calibrated."""
    chain_end = {id(rq_out[0]): mode for *_, rq_out, mode in calls["chains"]}
    steps = {}
    for a, res in calls["requant"]:
        mode = chain_end.get(id(res[0]))
        if mode == "requant":
            continue
        d, real_in, lo, hi = k5_requant_args(q, a)
        kind = "calibrated" if lo is not None else \
            "given" if mode == "range" else "own"
        amax = q.requant_range_reference(d, real_in) if kind == "given" \
            else None
        key = (tuple(d.shape), kind)
        steps.setdefault(key, [(d, real_in, lo, hi, amax), 0])[1] += 1
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for (shape, kind), ((d, real_in, lo, hi, amax), count) in steps.items():
        n = d.numel()
        rand = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             device="cuda", dtype=torch.int32)
        ramax = q.requant_range_reference(rand, real_in) \
            if kind == "given" else None

        def run(x, m):
            return q.requant_epilogue(x, real_in, lo, hi, amax=m)
        rows.append({
            "shape": list(shape), "mode": kind, "count": count,
            "ms": device_ms(lambda: run(d, amax), n=20),
            "random_ms": device_ms(lambda: run(rand, ramax), n=20),
            "plain_ms": device_ms(lambda: requant_plain(
                q, d, real_in, lo, hi), n=5),
            "bound_ms": int8_bound(0, 5.0 * n + 24)[0],
            "bytes": 5.0 * n + 24,
            "kernel_bytes": (9.0 if kind == "own" else 5.0) * n + 24})
        del rand
    req = {"calls": sum(r["count"] for r in rows), "per_shape": rows}
    for k in ("ms", "random_ms", "plain_ms", "bound_ms", "bytes",
              "kernel_bytes"):
        req[k] = sum(r[k] * r["count"] for r in rows)
    req["kernel_bound_ms"] = int8_bound(0, req["kernel_bytes"])[0]
    by_mode = {}
    for r in rows:
        by_mode[r["mode"]] = by_mode.get(r["mode"], 0) + r["count"]
    req["calls_by_mode"] = by_mode
    for r in rows:
        log(f"[c] requant_int8 {r['mode']} x{r['count']} {r['shape']}: "
            f"{r['ms']:.4f} ms device on the path's input, "
            f"{r['random_ms']:.4f} on random int32, bound "
            f"{r['bound_ms']:.4f} ({r['bound_ms'] / r['ms']:.1%}), plain "
            f"{r['plain_ms']:.4f}")
    log(f"[c] requant_int8 over the {req['calls']} standalone steps of one "
        f"fused bucket-128 predict ({by_mode}): {req['ms']:.4f} ms device "
        f"on the path's inputs, {req['random_ms']:.4f} on random int32 "
        f"({req['ms'] / req['random_ms'] - 1:+.1%}); bound "
        f"{req['bound_ms']:.4f} ms (bytes: {req['bytes'] / 1e9:.3f} GB), "
        f"{req['bound_ms'] / req['ms']:.1%} of it; with mode own's second "
        f"read {req['kernel_bytes'] / 1e9:.3f} GB, "
        f"{req['kernel_bound_ms']:.4f} ms, "
        f"{req['kernel_bound_ms'] / req['ms']:.1%}; plain "
        f"{req['plain_ms']:.4f} ms")
    (shape, _), ((_, real_in, lo, hi, _), _) = max(
        ((k, v) for k, v in steps.items() if k[1] == "calibrated"),
        key=lambda kv: kv[1][0][0].numel())
    sweep = {}
    for kind in RQ_SWEEP:
        x = rq_sweep_input(torch, gen, shape, kind)
        sweep[kind] = device_ms(lambda: q.requant_epilogue(x, real_in, lo,
                                                           hi), n=20)
        del x
    req["sweep_shape"], req["sweep_ms"] = list(shape), sweep
    log(f"[c] requant_int8 calibrated at {list(shape)} by input values "
        f"(bound {int8_bound(0, 5.0 * math.prod(shape))[0]:.4f} ms): " +
        ", ".join(f"{k} {v:.4f} ms" for k, v in sweep.items()))
    return req


def time_fused(torch, q, calls):
    """Each fused conv of the predict (19 chains, by shape and mode) on
    the path's own inputs: s8_conv_requant (mode range: and the
    requantize reading its word) against the unfused s8_conv + relu +
    requantize it replaces, device ms; its bound (int8 operations, or
    bytes: the int8 input and weight read once, the int8 or int32 output
    and its range written once) and the plain chain's time."""
    groups = {}
    for a, relu, calib, conv_out, _, mode in calls["chains"]:
        args, scal = chain_conv_args(q, a, relu, calib)
        key = (tuple(args[0].shape), tuple(args[1].shape), args[2], mode,
               relu)
        groups.setdefault(key, [(args, scal), 0])[1] += 1
    rows = []
    for (xs, ws, st, mode, relu), ((args, scal), count) in groups.items():
        real_in = scal["real_in"]
        lo, hi = scal.get("out_min"), scal.get("out_max")

        def fused():
            out = q.s8_conv_requant(*args, **scal)
            if mode == "range":
                q.requant_epilogue(out[0], real_in, amax=out[1])

        def unfused():
            out = q.s8_conv(*args[:5], layout=args[5], bias=args[6])
            if relu:
                out = out.clamp_min(0)
            q.requant_epilogue(out, real_in, lo, hi)

        def plain():
            out = q.s8_conv_requant_reference(*args, **scal)
            if mode == "range":
                q.requant_epilogue_reference(out[0], real_in, -out[1],
                                             out[1])
        out = q.s8_conv_requant(*args, **scal)[0]
        m, cout = out.numel() // ws[0], ws[0]
        k = ws[1] * ws[2] * ws[3]
        ops = 2.0 * m * cout * k
        nbytes = args[0].numel() + args[1].numel() + 4.0 * cout + 8 + \
            out.numel() * (1.0 if mode == "requant" else 4.0)
        bound_ms, bound_by = int8_bound(ops, nbytes)
        turns = {"fused": [], "unfused": []}
        for which, fn in (("fused", fused), ("unfused", unfused)) * 2:
            turns[which].append(device_ms(fn, n=10))
        with exact_f64_convs(torch):
            plain_ms = device_ms(plain, n=2)
        row = {"shape": [list(xs), list(ws), list(st)], "mode": mode,
               "relu": relu, "count": count,
               "ms": sum(turns["fused"]) / 2,
               "unfused_ms": sum(turns["unfused"]) / 2, "turns": turns,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "ops": ops, "bytes": nbytes}
        rows.append(row)
        with_rq = " (and the requantize reading its range)" \
            if mode == "range" else ""
        log(f"[c] s8_conv_requant [{mode}{', relu' if relu else ''}] "
            f"x{count} {xs} * {ws} s{st[0]}: fused {row['ms']:.4f} ms "
            f"device{with_rq}, unfused conv{' + relu' if relu else ''} + "
            f"requantize {row['unfused_ms']:.4f} "
            f"ms ({row['unfused_ms'] - row['ms']:+.4f}); bound "
            f"{bound_ms:.4f} ({bound_by}, {bound_ms / row['ms']:.1%}); "
            f"plain {plain_ms:.3f} ms")
        torch.cuda.empty_cache()
    tot = {"calls": sum(r["count"] for r in rows), "per_shape": rows}
    for k in ("ms", "unfused_ms", "plain_ms", "bound_ms", "ops", "bytes"):
        tot[k] = sum(r[k] * r["count"] for r in rows)
    tot["bound_by"] = ("bytes" if tot["bytes"] / PEAK_BYTES
                       >= tot["ops"] / PEAK_INT8_OPS else "operations")
    log(f"[c] the {tot['calls']} fused convs of one bucket-128 predict: "
        f"{tot['ms']:.4f} ms device against {tot['unfused_ms']:.4f} ms "
        f"unfused ({tot['unfused_ms'] - tot['ms']:+.4f}); bound "
        f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}), "
        f"{tot['bound_ms'] / tot['ms']:.1%}; plain {tot['plain_ms']:.3f} ms")
    return tot


# ------------------------------------------------------------------ phase q
AMP_STEPS = 10
# LAMB's rate: each weight matrix moves by lr times its norm a step. At
# 1e-3 (Adam's rate in phase h) the LM's loss fell only 0.205 in 10 steps
# on an H100 (PERF.md section 6); 1e-2 moves each matrix by 1 % a step
AMP_LR = 1e-2
AMP_GRAD_TOL = 5e-2     # of max|grad|: phase h's bf16 bound (fp16 products)
AMP_OPT_TOL = 1e-5      # of max|w|: an optimizer on the card vs a CPU copy
AMP_BF16_STEPS = 3
AMP_RESUME_STEPS = 5
# q6: every optimizer beyond SGD and Adam, gluon (create) and functional
# (parallel.make_update_fn), with the hyper-parameters each is tried with
AMP_GLUON = (("nag", {"momentum": 0.9}), ("adamw", {"eta": 0.5}),
             ("adagrad", {}), ("adadelta", {}), ("rmsprop", {}),
             ("rmsprop", {"centered": True}), ("ftrl", {}), ("adamax", {}),
             ("nadam", {}), ("signum", {}), ("sgld", {}),
             ("dcasgd", {"momentum": 0.9}), ("ftml", {}), ("lamb", {}),
             ("lars", {"momentum": 0.9}), ("lbsgd", {"momentum": 0.9}),
             ("test", {}))
AMP_FUNCTIONAL = (("nag", {"momentum": 0.9}), ("adamw", {"eta": 0.5}),
                  ("ftrl", {}), ("rmsprop", {}),
                  ("rmsprop", {"centered": True}), ("adagrad", {}),
                  ("adadelta", {}), ("adamax", {}), ("nadam", {}),
                  ("ftml", {}), ("signum", {}), ("lamb", {}), ("lars", {}),
                  ("dcasgd", {"momentum": 0.9}), ("sgld", {}))


_Q_FAILED = []


def q_check(ok, what):
    """Note a failed check of phase q; the phase runs its other parts and
    fails at its end (amp_phase), naming every failure."""
    if not ok:
        _Q_FAILED.append(what)


@contextlib.contextmanager
def flash_launch_spy(kernels):
    """Within this scope each K1 and K2 launch appends (kernel, q shape, q
    dtype) to the yielded list: spies on the launch functions, whose
    wrappers count the launches themselves."""
    seen = []
    orig = kernels._launch, kernels._launch_bwd

    def k1(q, *args, **kwargs):
        seen.append(("k1", tuple(q.shape), str(q.dtype)))
        return orig[0](q, *args, **kwargs)

    def k2(q, *args, **kwargs):
        seen.append(("k2", tuple(q.shape), str(q.dtype)))
        return orig[1](q, *args, **kwargs)

    kernels._launch, kernels._launch_bwd = k1, k2
    try:
        yield seen
    finally:
        kernels._launch, kernels._launch_bwd = orig


@contextlib.contextmanager
def output_dtype_spy():
    """Within this scope the dtypes LayerNorm, log_softmax (the loss's
    softmax) and mean (the loss's per-sample mean) return, by op: the op
    functions replaced by recording wrappers (the layers call them through
    their module)."""
    from mxnet_tpu_torch.ops import math as ops_math
    from mxnet_tpu_torch.ops import nn as ops_nn

    seen = {}
    spied = ((ops_nn, "layer_norm"), (ops_nn, "log_softmax"),
             (ops_math, "mean"))
    orig = [getattr(m, name) for m, name in spied]

    def wrap(fn, name):
        def spy(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.setdefault(name, set()).add(str(out.dtype))
            return out
        return spy

    for (m, name), fn in zip(spied, orig):
        setattr(m, name, wrap(fn, name))
    try:
        yield seen
    finally:
        for (m, name), fn in zip(spied, orig):
            setattr(m, name, fn)


def amp_lm(torch, mx, seed=0):
    """Phase h's LM at GPT-2-small widths, fp32 parameters, seeded
    Xavier."""
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    gen = torch.Generator(device="cuda").manual_seed(seed)
    net = transformer.transformer_lm(
        vocab=VOCAB, units=UNITS, num_heads=HEADS, num_layers=LAYERS,
        max_len=T, impl="flash", prefix="tlm_")
    net.initialize(mx.init.Xavier(), generator=gen)   # default ctx: gpu(0)
    return net


def amp_backward(mx, net, trainer, loss_fn, x, y):
    """MXNet's recipe up to the update: the per-sample losses summed (the
    update divides by the batch), scaled, backward. Returns the batch's
    mean loss as a 0-d tensor."""
    with mx.autograd.record():
        loss = loss_fn(net(x), y).sum()
    with mx.amp.scale_loss(loss, trainer) as scaled:
        scaled.backward()
    return loss.detach() / x.shape[0]


def amp_step(mx, net, trainer, loss_fn, x, y):
    """One step of the recipe: (mean loss tensor, whether the update ran)."""
    loss = amp_backward(mx, net, trainer, loss_fn, x, y)
    applied = mx.amp.unscale(trainer)
    if applied:
        trainer.step(x.shape[0])
    return loss, applied


def _trim_qkv_bias_grad(torch, name, g):
    """The key third of attn_qkv_bias has a true gradient of 0 (a bias on
    every key shifts a row's logits by a constant): both sides hold
    rounding noise there, so it is left out (as phase i does)."""
    if name.endswith("attn_qkv_bias"):
        return torch.cat((g[:UNITS], g[2 * UNITS:]))
    return g


def amp_train(torch, mx, kernels):
    """q1: the LM trained under AMP fp16 with LAMB (lr 1e-2), 10 steps of
    the recipe on phase h's batch: the loss falls >= 0.5; every step
    launches 12 K1 + 12 K2 on route "tc" with fp16 q / k / v and none on
    another route; LayerNorm, log_softmax and the loss's mean return fp32;
    the loss scale's trajectory, median step, tokens/s, peak memory; one
    more step profiled."""
    net = amp_lm(torch, mx)
    mx.amp.init("float16")
    mx.amp.reset_health_stats()
    trainer = mx.gluon.Trainer(net.collect_params(), "lamb",
                               {"learning_rate": AMP_LR})
    mx.amp.init_trainer(trainer)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = lm_batch(torch, BATCH, T, VOCAB)
    scaler = trainer._amp_loss_scaler
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    losses, step_ms, scales, per_step, skipped = [], [], [], [], 0
    with flash_launch_spy(kernels) as seen, output_dtype_spy() as dtypes:
        for i in range(AMP_STEPS):
            k1 = dict(kernels.flash_attention.launches_by_route)
            k2 = dict(kernels.flash_attention_backward.launches_by_route)
            first = len(seen)
            t0 = time.perf_counter()
            loss, applied = amp_step(mx, net, trainer, loss_fn, x, y)
            losses.append(loss.item())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            skipped += not applied
            scales.append(scaler.loss_scale)
            per_step.append((
                {r: n - k1[r] for r, n in
                 kernels.flash_attention.launches_by_route.items()},
                {r: n - k2[r] for r, n in
                 kernels.flash_attention_backward.launches_by_route.items()},
                sorted({(k, d) for k, _, d in seen[first:]})))
            log(f"[q1] step {i + 1}: loss {losses[-1]:.4f}, "
                f"{step_ms[-1]:.2f} ms (host clock), scale "
                f"{scales[-1]:g}{'' if applied else ' (overflow: skipped)'}, "
                f"K1 {per_step[-1][0]}, K2 {per_step[-1][1]}")
    k1_by_route = dict(kernels.flash_attention.launches_by_route)
    k2_by_route = dict(kernels.flash_attention_backward.launches_by_route)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    shapes = sorted({(k, s, d) for k, s, d in seen})
    timed = sorted(step_ms[1:])
    median = timed[len(timed) // 2]
    tokens_per_s = BATCH * T / (median / 1e3)
    drop = losses[0] - losses[-1]
    want_route = {"tc": LAYERS, "tf32x3": 0, "simt": 0}
    want_launch = [("k1", "torch.float16"), ("k2", "torch.float16")]
    fp32_ops = {op: sorted(d) for op, d in dtypes.items()}
    ok = (all(math.isfinite(v) for v in losses) and drop >= 0.5
          and all(a == b == want_route and kinds == want_launch
                  for a, b, kinds in per_step)
          and shapes == [("k1", (BATCH, HEADS, T, UNITS // HEADS),
                          "torch.float16"),
                         ("k2", (BATCH, HEADS, T, UNITS // HEADS),
                          "torch.float16")]
          and fp32_ops == {"layer_norm": ["torch.float32"],
                           "log_softmax": ["torch.float32"],
                           "mean": ["torch.float32"]})
    log(f"[q1] {AMP_STEPS} AMP fp16 LAMB steps (lr {AMP_LR:g}): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (drop {drop:.4f}, want >= "
        f"0.5); median step {median:.2f} ms over steps 2-{AMP_STEPS} (host "
        f"clock, profiler off), {tokens_per_s:.1f} tokens/s, peak "
        f"{peak_gib:.2f} GiB allocated; loss scale {scales} ({skipped} "
        f"skipped); K1 {k1_by_route}, K2 {k2_by_route} (want {LAYERS} + "
        f"{LAYERS} on 'tc' a step); launches {shapes}; output dtypes "
        f"{fp32_ops} {'ok' if ok else 'FAIL'}")
    q_check(ok, "q1: the AMP training step failed its checks")
    torch.cuda.synchronize()
    fb = profile_window(torch, lambda: amp_backward(
        mx, net, trainer, loss_fn, x, y), "one AMP step's forward + "
        "backward", "q1", ("flash_fwd", "flash_bwd"), top=12)
    upd = profile_window(torch, lambda: (mx.amp.unscale(trainer),
                                         trainer.step(BATCH)),
                         "one AMP step's unscale + LAMB update", "q1",
                         ("foreach", "elementwise", "vectorized"))
    groups = step_breakdown(fb["all"])
    groups["unscale + LAMB update (all its kernels)"] = (
        upd["device_busy_ms"], upd["launches"])
    busy = fb["device_busy_ms"] + upd["device_busy_ms"]
    wall = fb["wall_ms"] + upd["wall_ms"]
    log(f"[q1] one step profiled: device busy {busy:.3f} ms of {wall:.3f} "
        f"ms wall ({busy / wall:.1%}; profiler on); by group:")
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"[q1]   {ms:9.3f} ms  x{n:<5d} {group} ({ms / busy:.1%})")
    out = {"losses": losses, "step_ms": step_ms, "median_step_ms": median,
           "tokens_per_s": tokens_per_s, "peak_gib": peak_gib,
           "loss_scales": scales, "skipped": skipped,
           "k1_launches": sum(k1_by_route.values()),
           "k1_launches_by_route": k1_by_route,
           "k2_launches": sum(k2_by_route.values()),
           "k2_launches_by_route": k2_by_route,
           "launch_shapes": [list(s) for s in shapes],
           "output_dtypes": fp32_ops,
           "profile": {"forward_backward": {k: fb[k] for k in (
               "wall_ms", "device_busy_ms", "launches", "top")},
               "update": {k: upd[k] for k in (
                   "wall_ms", "device_busy_ms", "launches", "top")},
               "groups": {g: {"ms": ms, "launches": n}
                          for g, (ms, n) in groups.items()}}}
    return out, (net, trainer, loss_fn, x, y)


def _state_tensors(trainer):
    return [t for st in trainer._updater.states.values()
            for t in (st if isinstance(st, tuple) else (st,))
            if t is not None]


def amp_overflow(torch, mx, net, trainer, loss_fn, x, y):
    """q2: an inf put into one gradient of a step: unscale says False, the
    weights and LAMB's states are bitwise as they were, the scale halves,
    the skip is counted."""
    scaler = trainer._amp_loss_scaler
    amp_backward(mx, net, trainer, loss_fn, x, y)
    params = net._param_objects()
    name = next(iter(params))
    params[name].grad().view(-1)[7] = float("inf")
    weights = {n: t.clone() for n, t in net.collect_params().items()}
    states = [t.clone() for t in _state_tensors(trainer)]
    scale, skips = scaler.loss_scale, mx.amp.health_stats()
    applied = mx.amp.unscale(trainer)
    if applied:
        trainer.step(x.shape[0])
    torch.cuda.synchronize()
    same_w = all(torch.equal(t, weights[n])
                 for n, t in net.collect_params().items())
    same_s = all(torch.equal(a, b)
                 for a, b in zip(_state_tensors(trainer), states))
    after = mx.amp.health_stats()
    ok = (not applied and same_w and same_s
          and scaler.loss_scale == scale / 2
          and after["health_skipped_steps"] ==
          skips["health_skipped_steps"] + 1
          and after["amp_overflow_skips"] == skips["amp_overflow_skips"] + 1)
    log(f"[q2] inf in {name}'s gradient: unscale {applied} (want False), "
        f"weights bitwise unchanged {same_w}, {len(states)} LAMB states "
        f"bitwise unchanged {same_s}, scale {scale:g} -> "
        f"{scaler.loss_scale:g}, skips {skips} -> {after} "
        f"{'ok' if ok else 'FAIL'}")
    q_check(ok, "q2: the overflow step was not skipped cleanly")
    del weights, states
    return {"param": name, "scale_before": scale,
            "scale_after": scaler.loss_scale, "skips": after}


def amp_vs_fp32(torch, mx, kernels, net, trainer, loss_fn, x, y):
    """q3: one AMP fp16 step's gradients, unscaled, against the fp32 step's
    (K1 / K2 on "tf32x3", phase m's routes) on the same weights and batch:
    each parameter within 5e-2 of its max|grad| (phase h's bf16 bound)."""
    def grads():
        return {n: p.grad().detach().clone()
                for n, p in net._param_objects().items()}

    mx.amp.reset()
    zero_counts(kernels)
    with mx.autograd.record():
        loss32 = loss_fn(net(x), y).sum()
    loss32.backward()
    g32 = grads()
    routes32 = (dict(kernels.flash_attention.launches_by_route),
                dict(kernels.flash_attention_backward.launches_by_route))
    mx.amp.init("float16")
    scale = trainer._amp_loss_scaler.loss_scale
    loss16 = amp_backward(mx, net, trainer, loss_fn, x, y)
    g16 = {n: g / scale for n, g in grads().items()}
    errs = sorted(((rel_err(_trim_qkv_bias_grad(torch, n, g16[n]),
                            _trim_qkv_bias_grad(torch, n, g32[n])), n)
                   for n in g32), reverse=True)
    loss_err = abs(loss16.item() - loss32.item() / x.shape[0]) / abs(
        loss32.item() / x.shape[0])
    finite = all(bool(torch.isfinite(g).all()) for g in g16.values())
    ok = finite and errs[0][0] <= AMP_GRAD_TOL and \
        routes32[0]["tf32x3"] == routes32[1]["tf32x3"] == LAYERS
    log(f"[q3] AMP fp16 gradients (unscaled by {scale:g}) vs fp32 (K1 / K2 "
        f"{routes32}): loss rel {loss_err:.2e}; worst {errs[0][0]:.3e} of "
        f"max|grad| in {errs[0][1]} (tol {AMP_GRAD_TOL:g}, phase h's bf16 "
        f"bound), next {[(f'{e:.2e}', n) for e, n in errs[1:4]]} "
        f"{'ok' if ok else 'FAIL'}")
    q_check(ok, "q3: AMP gradients disagree with fp32")
    net.zero_grad()
    return {"worst": errs[0][0], "worst_param": errs[0][1],
            "loss_rel": loss_err, "scale": scale,
            "fp32_routes": routes32}


def amp_bf16(torch, mx, kernels, net, loss_fn, x, y):
    """q4: 3 steps of the recipe under amp.init() (bf16): the scale stays
    1.0 and K1 / K2 run on "tc" with bf16 q / k / v."""
    mx.amp.init()
    trainer = mx.gluon.Trainer(net.collect_params(), "lamb",
                               {"learning_rate": AMP_LR})
    mx.amp.init_trainer(trainer)
    zero_counts(kernels)
    losses, scales = [], []
    with flash_launch_spy(kernels) as seen:
        for _ in range(AMP_BF16_STEPS):
            loss, applied = amp_step(mx, net, trainer, loss_fn, x, y)
            losses.append(loss.item())
            scales.append(trainer._amp_loss_scaler.loss_scale)
    kinds = sorted({(k, d) for k, _, d in seen})
    k1 = dict(kernels.flash_attention.launches_by_route)
    k2 = dict(kernels.flash_attention_backward.launches_by_route)
    want = {"tc": LAYERS * AMP_BF16_STEPS, "tf32x3": 0, "simt": 0}
    ok = (all(math.isfinite(v) for v in losses) and scales ==
          [1.0] * AMP_BF16_STEPS and k1 == k2 == want
          and kinds == [("k1", "torch.bfloat16"), ("k2", "torch.bfloat16")])
    log(f"[q4] {AMP_BF16_STEPS} AMP bf16 steps: losses "
        f"{[round(v, 4) for v in losses]}, scale {scales}, K1 {k1}, K2 {k2},"
        f" launches {kinds} {'ok' if ok else 'FAIL'}")
    q_check(ok, "q4: the bf16 AMP steps failed their checks")
    return {"losses": losses, "scales": scales, "k1_launches_by_route": k1,
            "k2_launches_by_route": k2}


def amp_resume(torch, mx, net, loss_fn, x, y):
    """q5: 5 LAMB steps of the fp16 recipe, save_states, step 6; then the
    weights after step 5 again, a fresh Trainer with load_states, step 6:
    bitwise equal to the uninterrupted run's step 6."""
    mx.amp.init("float16")
    path = os.path.join(ROOT, "_amp_states", "trainer.states")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    trainer = mx.gluon.Trainer(net.collect_params(), "lamb",
                               {"learning_rate": AMP_LR})
    mx.amp.init_trainer(trainer)
    scaler = trainer._amp_loss_scaler
    for _ in range(AMP_RESUME_STEPS):
        amp_step(mx, net, trainer, loss_fn, x, y)
    trainer.save_states(path)
    # save_states holds the optimizer's states only; a CheckpointManager
    # checkpoint carries the loss scale too (phase w5): here it is
    # carried by hand
    saved_scale = (scaler.loss_scale, scaler._unskipped)
    after5 = {n: t.clone() for n, t in net.collect_params().items()}
    amp_step(mx, net, trainer, loss_fn, x, y)
    want = {n: t.clone() for n, t in net.collect_params().items()}
    for n, p in net._param_objects().items():
        p.set_data(after5[n])
    fresh = mx.gluon.Trainer(net.collect_params(), "lamb",
                             {"learning_rate": AMP_LR})
    mx.amp.init_trainer(fresh)
    scaler.loss_scale, scaler._unskipped = saved_scale
    fresh.load_states(path)
    amp_step(mx, net, fresh, loss_fn, x, y)
    torch.cuda.synchronize()
    diff = [n for n, t in net.collect_params().items()
            if not torch.equal(t, want[n])]
    size = os.path.getsize(path)
    import shutil

    shutil.rmtree(os.path.dirname(path))
    ok = not diff and fresh.optimizer.num_update == AMP_RESUME_STEPS + 1
    log(f"[q5] resumed step {AMP_RESUME_STEPS + 1} from save_states "
        f"({size} bytes) and a fresh Trainer: {len(want) - len(diff)} of "
        f"{len(want)} parameters bitwise equal to the uninterrupted run's "
        f"{'ok' if ok else 'FAIL ' + str(diff[:3])}")
    q_check(ok, "q5: the resumed step differs")
    del after5, want
    return {"bytes": size, "params": len(trainer._params)}


def _block_copies(torch, net):
    """Block 0's 12 parameters: (name, card tensor, CPU float32 copy)."""
    block = next(iter(net.blocks))
    return [(n, t.detach().clone(), t.detach().float().cpu())
            for n, t in block.collect_params().items()]


def _sweep_grads(torch, shapes, step):
    gen = torch.Generator().manual_seed(1000 + step)
    return [torch.randn(s, generator=gen) * 1e-2 for s in shapes]


def _normal_from_cpu(torch):
    """An SGLD noise source that gives the card and the CPU the same
    draws: the k-th call draws from a CPU generator seeded with k, moved to
    the weight's device."""
    calls = [0]

    def normal(like, std, generator):
        calls[0] += 1
        gen = torch.Generator().manual_seed(calls[0])
        noise = torch.randn(like.shape, generator=gen, dtype=like.dtype)
        return noise.to(like.device) * std
    return normal


def _optimizer_sweep(torch, mx, kind, name, kw, ws):
    """One update of the weights ``ws`` by the optimizer ``name``: a gluon
    Optimizer's update_group over them, or a functional update."""
    from mxnet_tpu_torch import parallel

    if kind == "gluon":
        opt = mx.optimizer.create(name, **kw)
        up = mx.optimizer.get_updater(opt)
        states = [up.state(i, w) for i, w in enumerate(ws)]

        def sweep(gs):
            scal = [opt._scalars(i) for i in range(len(ws))]
            opt.update_group(ws, gs, states, scal, 1.0)
        return sweep
    init, update = parallel.make_update_fn(name, dict(kw))
    pd = {str(i): w for i, w in enumerate(ws)}
    st = init(pd)

    def sweep(gs):
        update(pd, {str(i): g for i, g in enumerate(gs)}, st)
    return sweep


def graph_ms(torch, fn, phase, n=20):
    """Device ms of one call of ``fn`` captured as a CUDA graph: CUDA
    events around ``n`` replays queued behind a spin kernel, for
    launch-bound work, whose kernels one at a time leave device_ms's queue
    dry. A graph whose replay waits on the host (cuDNN's LSTM does) cannot
    be queued ahead: then the time is logged as holding host time. None
    (logged under ``phase``) if ``fn`` cannot be captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as e:
        log(f"[{phase}] capture refused: {str(e)[:120]} (not measured)")
        return None
    graph.replay()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e7))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        graph.replay()
    b.record()
    ran_dry = a.query()
    b.synchronize()
    ms = a.elapsed_time(b) / n
    if ran_dry:
        log(f"[{phase}] the host fell behind the graph's replays: "
            f"{ms:.3f} ms a replay holds host time")
    del graph
    return ms


def amp_optimizers(torch, mx, net):
    """q6: every optimizer beyond SGD and Adam, gluon and functional, 3
    updates of block 0's parameters on the card against the same updates
    of a CPU copy (the same gradients; SGLD's noise drawn on the CPU for
    both), within 1e-5 of max|w| (fp32); the device ms of one update of
    the 12 parameters (SGLD drawing its noise on the card), replayed from
    a CUDA graph."""
    from mxnet_tpu_torch.optimizer import optimizer as optim_mod

    mx.amp.reset()
    rows, worst = [], (0.0, "")
    orig_normal = optim_mod._normal
    for kind, table in (("gluon", AMP_GLUON), ("functional", AMP_FUNCTIONAL)):
        for name, kw in table:
            kw = dict(kw, learning_rate=kw.get("learning_rate", 0.01))
            copies = _block_copies(torch, net)
            shapes = [c[2].shape for c in copies]
            finals = []
            try:
                for side in (1, 2):             # the card, then the CPU
                    optim_mod._normal = _normal_from_cpu(torch)
                    ws = [c[side] for c in copies]
                    sweep = _optimizer_sweep(torch, mx, kind, name, kw, ws)
                    for step in range(3):
                        gs = _sweep_grads(torch, shapes, step)
                        sweep([g.cuda() for g in gs] if side == 1 else gs)
                    finals.append(ws)
            finally:
                optim_mod._normal = orig_normal
            err = max(float((a.float().cpu() - b).abs().max()) /
                      max(float(b.abs().max()), 1e-30)
                      for a, b in zip(*finals))
            sweep = _optimizer_sweep(torch, mx, kind, name, kw, finals[0])
            gs = [g.cuda() for g in _sweep_grads(torch, shapes, 9)]
            ms = graph_ms(torch, lambda: sweep(gs), "q6")
            rows.append({"kind": kind, "name": name, "params": kw,
                         "err": err, "ms": ms})
            worst = max(worst, (err, f"{kind} {name}"))
            took = "not measured" if ms is None else f"{ms:.4f} ms device"
            log(f"[q6] {kind} {name} {kw}: card vs CPU after 3 updates "
                f"{err:.2e} of max|w|, one update of block 0's 12 "
                f"parameters {took} (a CUDA graph of it replayed) "
                f"{'ok' if err <= AMP_OPT_TOL else 'FAIL'}")
    ok = worst[0] <= AMP_OPT_TOL
    log(f"[q6] {len(rows)} optimizer runs on the card against the CPU: "
        f"worst {worst[0]:.2e} of max|w| ({worst[1]}; tol {AMP_OPT_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    q_check(ok, "q6: an optimizer disagrees with its CPU copy")
    return {"runs": rows, "worst": worst[0], "worst_run": worst[1]}


def time_flash_fp16(torch, kernels):
    """K1 and K2 in fp16 at the LM's shape (8, 12, 1024, 64), causal, on
    contiguous q, k, v (route "tc"), in device time beside SDPA fp16 on the
    same inputs (forward; backward alone), their plain versions and the
    16-bit bound."""
    import torch.nn.functional as F

    shape = (BATCH, HEADS, T, UNITS // HEADS)
    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v, out, lse, dout, _ = bwd_inputs(
        torch, kernels, gen, shape, torch.float16, "contiguous", True, 0, 0,
        False)
    fwd_ms = device_ms(lambda: kernels.flash_attention(q, k, v, causal=True))
    bwd_ms = device_ms(lambda: kernels.flash_attention_backward(
        q, k, v, out, lse, dout, causal=True))
    fwd_plain = device_ms(lambda: kernels.flash_attention_reference(
        q, k, v, causal=True, return_lse=True), n=5)
    bwd_plain = device_ms(lambda: kernels.flash_attention_backward_reference(
        q, k, v, out, lse, dout, causal=True), n=3)
    fwd_lib = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o_sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True)
    bwd_lib = device_ms(lambda: torch.autograd.grad(
        o_sdpa, leaves, dout, retain_graph=True))
    fb, nb = attention_work(*shape, True, 2)
    f_bound, f_by = bound(fb, nb)
    bb, bn = attention_bwd_work(*shape, True, 2)
    b_bound, b_by = bound(bb, bn)
    log(f"[q] flash_attn_fwd_tc fp16 {shape} causal: kernel {fwd_ms:.4f} ms "
        f"device, SDPA fp16 {fwd_lib:.4f} ms ({fwd_ms / fwd_lib:.2f}x), "
        f"plain {fwd_plain:.4f} ms, bound {f_bound:.4f} ms by {f_by} "
        f"({f_bound / fwd_ms:.1%} of it)")
    log(f"[q] flash_attn_bwd_tc fp16 {shape} causal: kernel {bwd_ms:.4f} ms "
        f"device, SDPA fp16 backward {bwd_lib:.4f} ms "
        f"({bwd_ms / bwd_lib:.2f}x), plain {bwd_plain:.4f} ms, bound "
        f"{b_bound:.4f} ms by {b_by} ({b_bound / bwd_ms:.1%} of it)")
    return {"k1": {"ms": fwd_ms, "library_ms": fwd_lib, "plain_ms": fwd_plain,
                   "bound_ms": f_bound, "bound_by": f_by},
            "k2": {"ms": bwd_ms, "library_ms": bwd_lib, "plain_ms": bwd_plain,
                   "bound_ms": b_bound, "bound_by": b_by}}


def amp_phase(torch, mx, kernels):
    """Phase q: the training frontend on the card (AMP, the loss scaler,
    LAMB, Trainer states, every optimizer beyond SGD and Adam), then K1 /
    K2 in fp16 timed. AMP is off again at its end."""
    _Q_FAILED.clear()
    try:
        train, (net, trainer, loss_fn, x, y) = amp_train(torch, mx, kernels)
        overflow = amp_overflow(torch, mx, net, trainer, loss_fn, x, y)
        vs_fp32 = amp_vs_fp32(torch, mx, kernels, net, trainer, loss_fn, x,
                              y)
        bf16 = amp_bf16(torch, mx, kernels, net, loss_fn, x, y)
        resume = amp_resume(torch, mx, net, loss_fn, x, y)
        optimizers = amp_optimizers(torch, mx, net)
    finally:
        mx.amp.reset()
    del net, trainer
    torch.cuda.empty_cache()
    timing = time_flash_fp16(torch, kernels)
    if _Q_FAILED:
        raise SystemExit("phase q: " + "; ".join(_Q_FAILED))
    return {"train": train, "overflow": overflow, "vs_fp32": vs_fp32,
            "bf16": bf16, "resume": resume, "optimizers": optimizers,
            "fp16_timing": timing}


# ------------------------------------------------------------------ phase r
# examples/train_mnist.py's configuration: its get_iters (the synthetic set
# it trains on when no idx files are given, which is always here: they are
# not in the repository) and its mlp(), as the example has them, with
# mxnet_tpu_torch as mx
MNIST_BATCH, MNIST_EPOCHS, MNIST_LR = 128, 5, 0.05
R2_BATCH = 32
R3_DRAWS = 1_000_000
R3_DISPATCH_CALLS = 2000
MODULE_DIR = os.path.join(ROOT, "_module")   # gitignored: r2's export


def mnist_iters(mx, batch_size, shuffle=True):
    import numpy as np

    rng = np.random.RandomState(0)
    centers = rng.rand(10, 784).astype(np.float32)
    y = rng.randint(0, 10, 4096)
    X = centers[y] + rng.randn(4096, 784).astype(np.float32) * 0.15
    return (mx.io.NDArrayIter(X[:3584], y[:3584].astype(np.float32),
                              batch_size, shuffle=shuffle),
            mx.io.NDArrayIter(X[3584:], y[3584:].astype(np.float32),
                              batch_size))


def mnist_mlp(mx):
    sym = mx.sym
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=64, name="fc2")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=10, name="fc3")
    return sym.SoftmaxOutput(net, sym.Variable("softmax_label"),
                             name="softmax")


_R_FAILED = []


def r_check(ok, what):
    """Log a phase-r check; a failed one is collected and fails the phase
    at its end."""
    log(f"[r] {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        _R_FAILED.append(what)
    return ok


def module_mnist(torch, mx):
    """r1: the example's fit on gpu(0) (Module(context=None), SGD lr 0.05
    momentum 0.9, Xavier, 5 epochs, Speedometer(128, 50)), gated at
    validation accuracy 0.9; then the same fit with shuffle off from one
    set of initial parameters on gpu(0) and on cpu(): every parameter
    after 5 epochs within 1e-4 of max|w| (TF32 off); samples/s and ms an
    epoch on the host clock; one fit batch profiled."""
    opt = {"learning_rate": MNIST_LR, "momentum": 0.9}
    mx.random.seed(0)
    train, val = mnist_iters(mx, MNIST_BATCH)
    speed = mx.callback.Speedometer(MNIST_BATCH, 50)
    mod = mx.mod.Module(mnist_mlp(mx))
    t0 = time.perf_counter()
    mod.fit(train, eval_data=val, num_epoch=MNIST_EPOCHS, optimizer="sgd",
            optimizer_params=opt, initializer=mx.initializer.Xavier(),
            eval_metric="acc", batch_end_callback=speed)
    fit_s = time.perf_counter() - t0
    acc = mod.score(val, mx.metric.Accuracy())[0][1]
    ctx = mod._execs[0].arg_dict["fc1_weight"].context
    r_check(ctx == mx.gpu(0), f"r1 Module(context=None) ran on {ctx}")
    r_check(acc >= 0.9, f"r1 validation accuracy {acc:.4f} after "
            f"{MNIST_EPOCHS} epochs (>= 0.9, mxnet_tpu's bar); the fit took "
            f"{fit_s:.3f} s with its scoring; Speedometer "
            f"{[round(r, 1) for r in speed.rates]} samples/s (it logs "
            "every 50 batches of an epoch, which has 28)")

    mx.random.seed(1)
    init_mod = mx.mod.Module(mnist_mlp(mx), context=mx.cpu())
    init_mod.bind(train.provide_data, train.provide_label)
    init_mod.init_params(mx.initializer.Xavier())
    init = {k: v.asnumpy() for k, v in init_mod.get_params()[0].items()}
    fits = {}
    for name, ctx in (("gpu", mx.gpu(0)), ("cpu", mx.cpu())):
        it, _ = mnist_iters(mx, MNIST_BATCH, shuffle=False)
        stamps = []

        def stamp(*_):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        m = mx.mod.Module(mnist_mlp(mx), context=ctx)
        t0 = time.perf_counter()
        m.fit(it, num_epoch=MNIST_EPOCHS, optimizer="sgd",
              optimizer_params=opt, arg_params=init, eval_metric="acc",
              epoch_end_callback=stamp)
        epoch_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
        fits[name] = (m, epoch_ms)
    worst = 0.0
    g_params, c_params = (fits[k][0].get_params()[0] for k in ("gpu", "cpu"))
    for k in c_params:
        c, g = c_params[k].asnumpy(), g_params[k].asnumpy()
        err = float(abs(g - c).max() / max(abs(c).max(), 1e-12))
        worst = max(worst, err)
        r_check(err <= 1e-4, f"r1 {k}: gpu fit vs cpu fit, max|diff| / "
                f"max|w| {err:.3e} (tol 1e-4)")
    g_ms = fits["gpu"][1]
    steady = sorted(g_ms[1:])[len(g_ms[1:]) // 2]
    sps = 3584 / (steady / 1e3)
    log(f"[r1] gpu fit, shuffle off: ms an epoch {[round(x, 3) for x in g_ms]}"
        f" (median of epochs 2-5 {steady:.3f} ms, {sps:.1f} samples/s, host "
        f"clock, metric updates included); cpu fit "
        f"{[round(x, 3) for x in fits['cpu'][1]]} ms an epoch")
    m = fits["gpu"][0]
    it, _ = mnist_iters(mx, MNIST_BATCH, shuffle=False)
    batch = next(iter(it))
    prof = profile_window(
        torch, lambda: (m.forward_backward(batch), m.update()),
        "one Module fit batch (forward_backward + update)", "r1",
        ("gemm", "nvjet", "cutlass", "xmma", "sm90"))
    return {"val_accuracy": acc, "fit_s": fit_s,
            "speedometer_samples_per_s": speed.rates,
            "gpu_epoch_ms": g_ms, "cpu_epoch_ms": fits["cpu"][1],
            "median_epoch_ms": steady, "samples_per_s": sps,
            "gpu_vs_cpu_param_err": worst, "profile": prof}


def module_resnet(torch, mx):
    """r2: ResNet-18 v1 (224^2 NCHW fp32, 1000 classes, seeded Xavier)
    exported, loaded as a Symbol with a SoftmaxOutput head, bound by
    Module for training at batch 32; one forward_backward against the
    Gluon Block with the same weights under autograd.record() with
    SoftmaxCrossEntropyLoss summed over the batch (the same gradient when
    normalization='null'): every gradient within 1e-3 of its max|grad|,
    the BatchNorm moving statistics within 1e-5 of max(1, max|ref|). Then
    5 Module steps (forward_backward + update) beside 5 Gluon steps on
    the same batch, host clock with a synchronise."""
    import shutil

    from mxnet_tpu_torch.gluon.model_zoo import vision

    gen = torch.Generator(device="cuda").manual_seed(11)
    os.makedirs(MODULE_DIR, exist_ok=True)
    try:
        net = vision.resnet18_v1(classes=1000)
        net.initialize(mx.init.Xavier(), generator=gen)
        sym_file, params_file = net.export(os.path.join(MODULE_DIR,
                                                        "resnet18_v1"))
        out = mx.sym.SoftmaxOutput(mx.sym.load(sym_file),
                                   mx.sym.Variable("softmax_label"),
                                   name="softmax")
        params = mx.nd.load(params_file)
    finally:
        shutil.rmtree(MODULE_DIR, ignore_errors=True)
    aux_names = set(out.list_auxiliary_states())
    args = {k: v for k, v in params.items() if k not in aux_names}
    auxs = {k: v for k, v in params.items() if k in aux_names}
    mod = mx.mod.Module(out, context=mx.gpu(0))
    mod.bind([("data", (R2_BATCH, 3, 224, 224))],
             [("softmax_label", (R2_BATCH,))])
    mod.set_params(args, auxs)
    x = torch.randn((R2_BATCH, 3, 224, 224), generator=gen, device="cuda")
    y = torch.randint(0, 1000, (R2_BATCH,), generator=gen,
                      device="cuda").float()
    batch = mx.io.DataBatch([mx.nd.NDArray(x)], [mx.nd.NDArray(y)])
    mod.forward_backward(batch)
    ex = mod._execs[0]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(net(x), y).sum()
    loss.backward()
    ref = net.collect_params()
    worst = ("", 0.0)
    for n in mod._param_names:
        want = ref[n].grad
        err = float((ex.grad_dict[n]._data - want).abs().max()
                    / max(want.abs().max().item(), 1e-12))
        if err > worst[1]:
            worst = (n, err)
    r_check(worst[1] <= 1e-3, f"r2 {len(mod._param_names)} gradients "
            f"against Gluon's: worst {worst[0]} max|diff| / max|grad| "
            f"{worst[1]:.3e} (tol 1e-3)")
    stat = 0.0
    for n in aux_names:
        want = ref[n]
        stat = max(stat, float((ex.aux_dict[n]._data - want).abs().max()
                               / max(1.0, want.abs().max().item())))
    r_check(stat <= 1e-5, f"r2 {len(aux_names)} BatchNorm moving statistics "
            f"after the step: max|diff| / max(1, max|ref|) {stat:.3e} "
            "(tol 1e-5)")
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", opt)

    def module_step():
        mod.forward_backward(batch)
        mod.update()

    def gluon_step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y).sum()
        loss.backward()
        trainer.step(R2_BATCH)

    times = {}
    for name, step in (("module", module_step), ("gluon", gluon_step)):
        step()
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        times[name] = ms
    med = {k: sorted(v)[2] for k, v in times.items()}
    log(f"[r2] ResNet-18 training step at batch {R2_BATCH}: Module "
        f"{med['module']:.3f} ms, Gluon eager {med['gluon']:.3f} ms "
        f"(median of 5, host clock with a synchronise; {times})")
    del net, mod, trainer
    torch.cuda.empty_cache()
    return {"grad_err": worst[1], "grad_err_param": worst[0],
            "stat_err": stat, "step_ms": times, "median_step_ms": med}


def _r3_battery(np, gen):
    """(name, inputs, params, tol): a call of every op family; tol is the
    allowed max|gpu - cpu| / max(1, max|cpu|)."""
    def r(*s):
        return gen.uniform(-1, 1, s).astype(np.float32)

    def p(*s):
        return gen.uniform(0.5, 2, s).astype(np.float32)

    spd = r(2, 4, 4)
    spd = spd @ spd.transpose(0, 2, 1) + 4 * np.eye(4, dtype=np.float32)
    f32 = np.float32
    return [
        ("broadcast_add", [r(64, 32), r(1, 32)], {}, 1e-6),
        ("broadcast_greater", [r(64, 32), r(64, 32)], {}, 0),
        ("elemwise_pow_scalar", [p(64, 32)], {"scalar": 2.5}, 1e-5),
        ("erf", [r(64, 32)], {}, 1e-5),
        ("gammaln", [p(64, 32)], {}, 1e-5),
        ("sum", [r(8, 64, 32)], {"axis": (0, 2)}, 1e-5),
        ("argmax", [r(64, 32)], {"axis": 1}, 0),
        ("norm", [r(64, 32)], {}, 1e-5),
        ("dot", [r(64, 128), r(128, 32)], {}, 1e-5),
        ("batch_dot", [r(4, 64, 128), r(4, 128, 32)], {}, 1e-5),
        ("linalg_gemm2", [r(2, 32, 16), r(2, 16, 8)], {"alpha": 2.0}, 1e-5),
        ("linalg_potrf", [spd], {}, 1e-5),
        ("linalg_inverse", [spd], {}, 1e-4),
        ("Reshape", [r(4, 6, 8)], {"shape": (-4, 2, -1, -3)}, 0),
        ("transpose", [r(4, 6, 8)], {"axes": (2, 0, 1)}, 0),
        ("slice", [r(16, 16)], {"begin": (1, None), "end": (9, None),
                                "step": (2, -1)}, 0),
        ("Concat", [r(4, 8), r(2, 8)], {"dim": 0}, 0),
        ("take", [r(16, 8), np.array([0, 15, 20, -3], f32)], {}, 0),
        ("pick", [r(16, 8), gen.randint(0, 8, 16).astype(f32)], {}, 0),
        ("one_hot", [np.array([0, 3, 7], f32)], {"depth": 8}, 0),
        ("topk", [gen.permutation(64).reshape(4, 16).astype(f32)],
         {"k": 3, "ret_typ": "both"}, 0),
        ("sort", [r(4, 64)], {"is_ascend": False}, 0),
        ("FullyConnected", [r(32, 64), r(16, 64), r(16)],
         {"num_hidden": 16}, 1e-5),
        ("Convolution", [r(4, 8, 16, 16), r(16, 8, 3, 3), r(16)],
         {"kernel": (3, 3), "num_filter": 16, "pad": (1, 1)}, 1e-5),
        ("Deconvolution", [r(2, 8, 8, 8), r(8, 4, 4, 4)],
         {"kernel": (4, 4), "num_filter": 4, "stride": (2, 2),
          "pad": (1, 1)}, 1e-5),
        ("Pooling", [r(4, 8, 16, 16)], {"kernel": (2, 2), "stride": (2, 2),
                                        "pool_type": "lp"}, 1e-5),
        ("BatchNorm", [r(4, 8, 6, 6), p(8), r(8), r(8), p(8)],
         {"fix_gamma": False}, 1e-5),
        ("LayerNorm", [r(16, 64), p(64), r(64)], {}, 1e-5),
        ("GroupNorm", [r(4, 8, 6, 6), p(2), r(2)], {"num_groups": 2}, 1e-5),
        ("LeakyReLU", [r(64, 32)], {"act_type": "gelu"}, 1e-5),
        ("softmax", [r(64, 32)], {"temperature": 2.0}, 1e-6),
        ("SoftmaxOutput", [r(64, 10), gen.randint(0, 10, 64).astype(f32)],
         {}, 1e-6),
        ("UpSampling", [r(2, 4, 8, 8)], {"scale": 2,
                                         "sample_type": "bilinear"}, 1e-5),
        ("_contrib_interleaved_matmul_selfatt_qk", [r(16, 4, 96)],
         {"heads": 4}, 1e-5),
        ("_random_pdf_normal", [r(4, 64), r(4), p(4)], {}, 1e-5),
        ("histogram", [r(4096)], {"bin_cnt": 16, "range": (-1.0, 1.0)}, 0),
        ("_arange", [], {"start": 0.0, "stop": 12.0, "step": 1.5}, 0),
    ]


def nd_on_card(torch, mx, kernels):
    """r3: the op battery on gpu(0) against cpu(); K1 / K2 through
    mx.nd.scaled_dot_product_attention(impl='flash') at the LM's shape in
    bf16 (exactly one tensor-core K1 and K2 launch, no plain version,
    bitwise equal to the direct Function, the same through a bound Symbol
    graph); the samplers' statistics over 1e6 draws and mx.random.seed's
    repeat; host microseconds a call of three mx.nd ops beside the bare
    torch calls."""
    import numpy as np

    gen = np.random.RandomState(0)
    worst = {}
    for name, inputs, params, tol in _r3_battery(np, gen):
        outs = []
        for ctx in (mx.gpu(0), mx.cpu()):
            arrays = [mx.nd.array(a, ctx=ctx) for a in inputs]
            with ctx:
                o = getattr(mx.nd, name)(*arrays, **params)
            outs.append([t.asnumpy() for t in (
                o if isinstance(o, (list, tuple)) else [o])])
        err = max(float(np.abs(g.astype(np.float64) - c).max()
                        / max(1.0, float(np.abs(c).max())))
                  for g, c in zip(*outs))
        worst[name] = err
        r_check(err <= tol, f"r3 nd.{name} gpu vs cpu: {err:.3e} "
                f"(tol {tol:g} of max(1, max|cpu|))")

    # K1 / K2 through mx.nd
    shape = (BATCH, HEADS, T, UNITS // HEADS)
    tgen = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, dout = (torch.randn(shape, generator=tgen, device="cuda",
                                 dtype=torch.bfloat16) for _ in range(4))
    plain_cuda = []
    orig = kernels.flash_attention_reference, \
        kernels.flash_attention_backward_reference

    def fwd_spy(q_, *a, **kw):
        plain_cuda.append(q_.is_cuda)
        return orig[0](q_, *a, **kw)

    def bwd_spy(q_, *a, **kw):
        plain_cuda.append(q_.is_cuda)
        return orig[1](q_, *a, **kw)

    kernels.flash_attention_reference, \
        kernels.flash_attention_backward_reference = fwd_spy, bwd_spy
    try:
        arrs = [mx.nd.NDArray(t.clone()) for t in (q, k, v)]
        for a in arrs:
            a.attach_grad()
        zero_counts(kernels)
        with mx.autograd.record():
            o = mx.nd.scaled_dot_product_attention(*arrs, causal=True,
                                                   impl="flash")
        o.backward(mx.nd.NDArray(dout))
        torch.cuda.synchronize()
        k1 = dict(kernels.flash_attention.launches_by_route)
        k2 = dict(kernels.flash_attention_backward.launches_by_route)
        launches = {"k1": kernels.flash_attention.launches,
                    "k2": kernels.flash_attention_backward.launches,
                    "k1_by_route": k1, "k2_by_route": k2}
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        direct = kernels.flash_attention_with_grad(*leaves, causal=True)
        direct.backward(dout)
        s = mx.sym.scaled_dot_product_attention(
            mx.sym.Variable("q"), mx.sym.Variable("k"), mx.sym.Variable("v"),
            causal=True, impl="flash")
        ex = s.simple_bind(mx.gpu(0), q=shape, k=shape, v=shape,
                           type_dict={n: "bfloat16" for n in "qkv"})
        for n, t in zip("qkv", (q, k, v)):
            ex.arg_dict[n][:] = mx.nd.NDArray(t)
        zero_counts(kernels)
        ex.forward(is_train=True)
        ex.backward(out_grads=[mx.nd.NDArray(dout)])
        torch.cuda.synchronize()
        sym_launches = (kernels.flash_attention.launches_by_route["tc"],
                        kernels.flash_attention_backward.launches_by_route[
                            "tc"], kernels.flash_attention.launches,
                        kernels.flash_attention_backward.launches)
    finally:
        kernels.flash_attention_reference, \
            kernels.flash_attention_backward_reference = orig
    r_check(launches["k1"] == 1 and k1["tc"] == 1 and launches["k2"] == 1
            and k2["tc"] == 1, f"r3 nd.scaled_dot_product_attention "
            f"{shape} bf16 causal: K1 {k1}, K2 {k2} (exactly one each on "
            "route tc)")
    r_check(not any(plain_cuda), f"r3 no plain version on a CUDA tensor "
            f"({sum(plain_cuda)} calls)")
    same = [torch.equal(o._data, direct)] + [
        torch.equal(a.grad._data, leaf.grad) for a, leaf in zip(arrs,
                                                                leaves)]
    r_check(all(same), f"r3 output, dq, dk, dv bitwise equal to "
            f"kernels.flash_attention_with_grad called directly: {same}")
    sym_same = [torch.equal(ex.outputs[0]._data, direct)] + [
        torch.equal(ex.grad_dict[n]._data, leaf.grad)
        for n, leaf in zip("qkv", leaves)]
    r_check(all(sym_same) and sym_launches == (1, 1, 1, 1),
            f"r3 the same through a bound Symbol graph (simple_bind, "
            f"forward, backward): bitwise {sym_same}, tc launches "
            f"(K1, K2, all K1, all K2) {sym_launches}")

    # random
    draws = []
    for _ in range(2):
        mx.random.seed(0)
        with mx.gpu(0):
            draws.append(torch.cat([
                mx.random.uniform(shape=(4096,))._data,
                mx.random.normal(shape=(4096,))._data,
                mx.random.gamma(2.0, shape=(4096,))._data,
                mx.nd.Dropout(mx.nd.ones((4096,)), p=0.5,
                              mode="always")._data]))
    r_check(torch.equal(draws[0], draws[1]), "r3 mx.random.seed(0) repeats "
            "uniform, normal, gamma and Dropout draws bitwise on gpu(0)")
    stats = {}
    for name, params, mean, var in (
            ("_random_uniform", {"low": -1.0, "high": 3.0}, 1.0, 16 / 12),
            ("_random_normal", {"loc": 1.0, "scale": 2.0}, 1.0, 4.0),
            ("_random_gamma", {"alpha": 2.5, "beta": 0.5}, 1.25, 0.625),
            ("_random_exponential", {"lam": 2.0}, 0.5, 0.25),
            ("_random_poisson", {"lam": 3.0}, 3.0, 3.0),
            ("_random_negative_binomial", {"k": 3, "p": 0.4}, 4.5, 11.25),
            ("_random_generalized_negative_binomial",
             {"mu": 2.0, "alpha": 0.5}, 2.0, 4.0),
            ("_random_randint", {"low": 0, "high": 10}, 4.5, 8.25),
            ("_random_bernoulli", {"p": 0.3}, 0.3, 0.21)):
        with mx.gpu(0):
            x = getattr(mx.nd, name)(shape=(R3_DRAWS,), **params)._data
        x = x.double()
        m, v_ = x.mean().item(), x.var(unbiased=False).item()
        mu4 = ((x - m) ** 4).mean().item()
        se_m, se_v = math.sqrt(var / R3_DRAWS), math.sqrt(
            max(mu4 - v_ * v_, 0) / R3_DRAWS)
        stats[name] = {"mean": m, "var": v_, "want": (mean, var),
                       "se": (se_m, se_v)}
        r_check(abs(m - mean) < 5 * se_m and abs(v_ - var) < 5 * se_v,
                f"r3 nd.{name} over {R3_DRAWS} draws on gpu(0): mean {m:.5f}"
                f" (want {mean:.5f}, 5 SE {5 * se_m:.5f}), var {v_:.5f} "
                f"(want {var:.5f}, 5 SE {5 * se_v:.5f})")

    # dispatch: host time of an mx.nd call beside the bare torch call
    a = mx.nd.ones((64, 64), ctx=mx.gpu(0))
    t = a._data
    dispatch = {}
    for name, nd_call, torch_call in (
            ("elemwise_add", lambda: a + a, lambda: t + t),
            ("relu", lambda: mx.nd.relu(a), lambda: torch.relu(t)),
            ("sum(axis=1)", lambda: mx.nd.sum(a, axis=1),
             lambda: t.sum(dim=1))):
        us = {}
        for kind, fn in (("nd", nd_call), ("torch", torch_call)):
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(R3_DISPATCH_CALLS):
                fn()
            torch.cuda.synchronize()
            us[kind] = (time.perf_counter() - t0) * 1e6 / R3_DISPATCH_CALLS
        dispatch[name] = us
        log(f"[r3] dispatch {name} (64, 64) fp32: mx.nd {us['nd']:.2f} us a "
            f"call, torch {us['torch']:.2f} us, overhead "
            f"{us['nd'] - us['torch']:.2f} us (host clock, {R3_DISPATCH_CALLS}"
            " calls then a synchronise)")
    return {"battery_err": worst, "sdpa_launches": launches,
            "sdpa_sym_launches": sym_launches, "random": stats,
            "dispatch_us": dispatch}


def kvstore_on_card(torch, mx):
    """r4: 'local' and 'device' stores on gpu(0): push of 4 values then
    pull bitwise equal to ((v0 + v1) + v2) + v3; set_optimizer's update
    bitwise equal to the same Updater applied directly; optimizer states
    through save / load, then one more push on each, bitwise."""
    import shutil

    gen = torch.Generator(device="cuda").manual_seed(23)
    vals = [torch.randn((256, 128), generator=gen, device="cuda")
            for _ in range(4)]
    want = ((vals[0] + vals[1]) + vals[2]) + vals[3]
    for kind in ("local", "device"):
        kv = mx.kv.create(kind)
        kv.init("w", mx.nd.zeros((256, 128), ctx=mx.gpu(0)))
        kv.push("w", [mx.nd.NDArray(v) for v in vals])
        got = mx.nd.zeros((256, 128), ctx=mx.gpu(0))
        kv.pull("w", out=got)
        r_check(torch.equal(got._data, want), f"r4 kvstore '{kind}': push "
                "of 4 values, pull: bitwise their sum in list order")
    w0 = torch.randn((256, 128), generator=gen, device="cuda")
    kv = mx.kv.create("device")
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                         momentum=0.9, wd=1e-4))
    kv.init(0, mx.nd.NDArray(w0.clone()))
    upd = mx.optimizer.get_updater(mx.optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9, wd=1e-4))
    direct = w0.clone()
    for v in vals[:2]:
        kv.push(0, mx.nd.NDArray(v))
        upd(0, v, direct)
    out = mx.nd.zeros((256, 128), ctx=mx.gpu(0))
    kv.pull(0, out=out)
    r_check(torch.equal(out._data, direct), "r4 set_optimizer: 2 pushes "
            "bitwise equal to the same Updater applied directly")
    fname = os.path.join(MODULE_DIR, "kv.states")
    os.makedirs(MODULE_DIR, exist_ok=True)
    try:
        kv.save_optimizer_states(fname)
        kv2 = mx.kv.create("device")
        kv2.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9, wd=1e-4))
        kv2.init(0, mx.nd.NDArray(out._data.clone()))
        kv2.load_optimizer_states(fname)
    finally:
        shutil.rmtree(MODULE_DIR, ignore_errors=True)
    for store in (kv, kv2):
        store.push(0, mx.nd.NDArray(vals[2]))
    a, b = (mx.nd.zeros((256, 128), ctx=mx.gpu(0)) for _ in range(2))
    kv.pull(0, out=a)
    kv2.pull(0, out=b)
    r_check(torch.equal(a._data, b._data), "r4 save_optimizer_states / "
            "load_optimizer_states: the next push bitwise equal")
    return {"ok": True}


def module_phase(torch, mx, kernels):
    """Phase r: the imperative and Module front end on the card (r1-r4);
    its checks collect failures and the phase fails at its end naming
    them all."""
    _R_FAILED.clear()
    mnist = module_mnist(torch, mx)
    resnet = module_resnet(torch, mx)
    nd = nd_on_card(torch, mx, kernels)
    kv = kvstore_on_card(torch, mx)
    if _R_FAILED:
        raise SystemExit("phase r: " + "; ".join(_R_FAILED))
    return {"mnist": mnist, "resnet": resnet, "nd": nd, "kvstore": kv}


# ------------------------------------------------------------------ phase s
# MXNet 1.6's example/rnn/word_lm tied 650-d setting (SURVEY.md:421): two
# LSTM layers of 650 units over 650-d embeddings, the decoder's weight the
# embedding's Variable, PTB's 10,000-word vocabulary; trained through
# BucketingModule with example/rnn/bucketing/lstm_bucketing.py's buckets,
# batch 32 and examples/rnn/word_lm.py's Adam at lr 0.01. PTB is not in the
# repository, so the text is word_lm.py's synthetic stream
# x[t+1] = (3 x[t] + 7) mod vocab.
LM_VOCAB, LM_UNITS, LM_LAYERS = 10000, 650, 2
LM_BUCKETS = (10, 20, 30, 40, 50, 60)
LM_BATCH, LM_LR = 32, 0.01
LM_SWEEPS = 10          # each sweep runs every bucket once, in a drawn order
LM_CPU_STEPS = 3        # the card's fit against a CPU copy over these steps
LM_CPU_TOL = 1e-4       # of max|w|, max|grad| and max|Adam state|
# Adam's update lr_t m / (sqrt(v) + eps) moves by at most
# lr_t * ADAM_GAIN * |dg| / (sqrt(v) + eps) when an element's (rescaled)
# gradient moves by dg: (1 - b1) from m, and from v at most (1 - b1) /
# sqrt(1 - b1^2 / b2), the bound of |m| / sqrt(v) (Cauchy-Schwarz over the
# steps), b1 0.9 and b2 0.999 as Adam's defaults. Where sqrt(v) is small
# the float noise of two devices' gradients alone moves the update past
# the tolerance, so the full step's weights are held on the elements
# where it cannot (word_lm_cpu_step).
ADAM_GAIN = 0.1 * (1 + 1 / math.sqrt(1 - 0.9 ** 2 / 0.999))
S_GLUON_TOL = 1e-5      # gluon.rnn.LSTM against the op, of max|ref|
S_CARD_TOL = 1e-5       # small widths on the card against the CPU
S_CUDNN_TOL = 1e-4      # the op against torch.nn.LSTM (cuDNN), of max|out|
S_SWITCHES = 600

_S_FAILED = []


def s_check(ok, what):
    """Log a phase-s check; a failed one is collected and fails the phase
    at its end."""
    log(f"[s] {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        _S_FAILED.append(what)
    return ok


def word_lm_sym_gen(mx):
    """examples/rnn/word_lm.py's sym_gen at the tied setting: Embedding ->
    transpose -> RNN(lstm) -> transpose / reshape -> FullyConnected over
    the embedding's weight -> SoftmaxOutput."""
    sym = mx.sym

    def sym_gen(seq_len):
        data, label = sym.Variable("data"), sym.Variable("softmax_label")
        weight = sym.Variable("embed_weight")
        emb = sym.Embedding(data, weight=weight, input_dim=LM_VOCAB,
                            output_dim=LM_UNITS, name="embed")
        rnn = sym.RNN(sym.transpose(emb, axes=(1, 0, 2)),
                      state_size=LM_UNITS, num_layers=LM_LAYERS,
                      mode="lstm", name="lstm")
        out = sym.transpose(rnn, axes=(1, 0, 2)).reshape((-1, LM_UNITS))
        logits = sym.FullyConnected(out, weight=weight, num_hidden=LM_VOCAB,
                                    name="pred")
        return (sym.SoftmaxOutput(logits, sym.reshape(label, shape=(-1,)),
                                  name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def word_lm_sweeps(seed=0, n_sweeps=LM_SWEEPS):
    """``n_sweeps`` sweeps, each the buckets in an order drawn by
    RandomState(seed); a batch is the next LM_BATCH x (T + 1) tokens of
    word_lm.py's synthetic stream, as its batches() cuts them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    orders = [[LM_BUCKETS[i] for i in rng.permutation(len(LM_BUCKETS))]
              for _ in range(n_sweeps)]
    need = sum(LM_BATCH * (t + 1) for order in orders for t in order)
    x = [int(rng.randint(LM_VOCAB))]
    for _ in range(need - 1):
        x.append((3 * x[-1] + 7) % LM_VOCAB)
    stream, i, sweeps = np.asarray(x), 0, []
    for order in orders:
        batches = []
        for t in order:
            chunk = stream[i:i + LM_BATCH * (t + 1)].reshape(LM_BATCH, t + 1)
            i += LM_BATCH * (t + 1)
            batches.append((t, chunk[:, :-1].astype(np.float32),
                            chunk[:, 1:].astype(np.float32)))
        sweeps.append(batches)
    return sweeps


def word_lm_batch(mx, t, x, y):
    return mx.io.DataBatch(
        data=[mx.nd.array(x, ctx=mx.cpu())],
        label=[mx.nd.array(y, ctx=mx.cpu())], bucket_key=t,
        provide_data=[mx.io.DataDesc("data", (LM_BATCH, t))],
        provide_label=[mx.io.DataDesc("softmax_label", (LM_BATCH, t))])


def word_lm_module(mx, ctx, arg=None):
    """The BucketingModule on ``ctx``, bound at the default bucket (60),
    its parameters Xavier from mx.random.seed(0) or ``arg``, Adam; with
    {bucket: Modules generated} counted."""
    mod = mx.mod.BucketingModule(word_lm_sym_gen(mx),
                                 default_bucket_key=max(LM_BUCKETS),
                                 context=ctx)
    gens, make = {}, mod._gen_module

    def counted(key):
        gens[key] = gens.get(key, 0) + 1
        return make(key)

    mod._gen_module = counted
    t = max(LM_BUCKETS)
    mod.bind([mx.io.DataDesc("data", (LM_BATCH, t))],
             [mx.io.DataDesc("softmax_label", (LM_BATCH, t))])
    if arg is None:
        mx.random.seed(0)
        mod.init_params(mx.initializer.Xavier())
    else:
        mod.init_params(arg_params=arg, aux_params={})
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": LM_LR})
    return mod, gens


def word_lm_step(mod, batch):
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()


def word_lm_flops(t):
    """Forward and backward FLOPs of one bucket-``t`` step: the LSTM's
    gate products and the decoder (2 FLOPs a MAC, x3 for the backward)."""
    macs = LM_LAYERS * 4 * LM_UNITS * 2 * LM_UNITS + LM_UNITS * LM_VOCAB
    return 6 * LM_BATCH * t * macs


def word_lm_grads(mod):
    """The current bucket's gradients on the host, by parameter name."""
    m = mod._curr_module
    return {n: m._execs[0].grad_dict[n].asnumpy() for n in m._param_names}


def word_lm_rel(np, got, want, keep=None):
    """{name: max|got - want| / max|want|}, over ``keep``'s elements when
    given."""
    out = {}
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        diff = np.abs(got[k].astype(np.float64) - w)
        if keep is not None:
            diff = np.where(keep[k], diff, 0.0)
        out[k] = float(diff.max() / scale)
    return out


def word_lm_adam(np, mod):
    """The updater's Adam states on the host: {name: (m, v)}."""
    return {k: tuple(t.detach().cpu().numpy() for t in st)
            for k, st in mod._curr_module._updater.states.items()}


def word_lm_pre(mod):
    """The weights (host) and the updater's states and counts (bytes)
    before a step, for word_lm_cpu_step."""
    return ({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
            mod._curr_module._updater.get_states())


def word_lm_nll(mod, batch):
    """The mean NLL of the last forward's outputs on ``batch``."""
    probs = mod.get_outputs()[0]._data
    labels = batch.label[0]._data.to(probs.device).long().reshape(-1)
    return float(-probs.gather(1, labels[:, None]).clamp_min(
        1e-10).log().mean())


def word_lm_cpu_step(torch, np, mx, card, full, adam, pre, batch):
    """One of s1's first LM_CPU_STEPS steps, the card's already taken, on
    two CPU copies that first get the card's weights, Adam states and
    update counts from before it (``pre``): ``full`` takes the whole step
    on its own gradients, ``adam`` only Adam's update on the card's. Gated,
    each at LM_CPU_TOL of the CPU's max: the card's gradients; its weights
    and Adam states against ``adam``'s (every element); its weights against
    ``full``'s on the elements where the largest gradient difference
    measured in this step, through ADAM_GAIN, cannot move Adam's update by
    the tolerance (the rest counted, and reported over every element)."""
    w_pre, states = pre
    for m in (full, adam):
        m.set_params({k: mx.nd.array(v, ctx=mx.cpu())
                      for k, v in w_pre.items()}, {})
        m._curr_module._updater.set_states(states)
    full.forward(batch, is_train=True)
    full.backward()
    g_card, g_cpu = word_lm_grads(card), word_lm_grads(full)
    v_pre = {k: st[1] for k, st in word_lm_adam(np, full).items()}
    full.update()
    grads = adam._curr_module._execs[0].grad_dict
    for k, g in g_card.items():
        grads[k]._data.copy_(torch.from_numpy(g))
    adam.update()
    host = lambda m: {k: v.asnumpy() for k, v in m.get_params()[0].items()}  # noqa
    w_card, w_full, w_adam = host(card), host(full), host(adam)
    s_card, s_adam = word_lm_adam(np, card), word_lm_adam(np, adam)
    opt = full._curr_module._updater.optimizer
    out = {"grads": word_lm_rel(np, g_card, g_cpu),
           "adam_weights": word_lm_rel(np, w_card, w_adam)}
    for i, part in enumerate(("adam_m", "adam_v")):
        out[part] = word_lm_rel(np, {k: v[i] for k, v in s_card.items()},
                                {k: v[i] for k, v in s_adam.items()})
    keep, left_out = {}, {}
    for k, g in g_cpu.items():
        t = opt._index_update_count[k]
        lr_t = opt.lr * math.sqrt(1 - opt.beta2 ** t) / (1 - opt.beta1 ** t)
        dg = float(np.abs(g_card[k] - g).max()) * opt.rescale_grad
        gmin = np.maximum(np.abs(g) * opt.rescale_grad - dg, 0.0)
        v_lo = opt.beta2 * v_pre.get(k, 0.0) + (1 - opt.beta2) * gmin ** 2
        tol = LM_CPU_TOL * float(np.abs(w_full[k]).max())
        keep[k] = lr_t * ADAM_GAIN * dg <= tol * (np.sqrt(v_lo) + opt.epsilon)
        left_out[k] = int((~keep[k]).sum())
    out["weights_kept"] = word_lm_rel(np, w_card, w_full, keep)
    out["weights_all"] = word_lm_rel(np, w_card, w_full)
    out["left_out"] = left_out
    return out


def word_lm_train(torch, mx):
    """s1: the tied 650-d word LM trained through BucketingModule on the
    card: every bucket bound once, over the parameter and gradient tensors
    of the default bucket; the last sweep's perplexity at most half the
    first's; each of the first 3 steps against CPU copies from the card's
    state before it (word_lm_cpu_step); step ms by bucket, tokens/s, a
    profiled bucket-60 step, peak memory and ms a bucket switch."""
    import numpy as np

    sweeps = word_lm_sweeps()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mod, gens = word_lm_module(mx, mx.gpu(0))
    init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    n_params = sum(v.size for v in init.values())
    full, adam = (word_lm_module(mx, mx.cpu(), {
        k: mx.nd.array(v, ctx=mx.cpu()) for k, v in init.items()})[0]
        for _ in range(2))
    metric = mx.metric.Perplexity(ignore_label=None)
    ppl, first_ms, step_ms = [], {}, {t: [] for t in LM_BUCKETS}
    cpu_checks, nll = [], []
    step = 0
    for sweep in sweeps:
        metric.reset()
        for t, x, y in sweep:
            batch = word_lm_batch(mx, t, x, y)
            if step < LM_CPU_STEPS:    # the card's state before the step
                pre = word_lm_pre(mod)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            word_lm_step(mod, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if t in first_ms:
                step_ms[t].append(ms)
            else:
                first_ms[t] = ms
            mod.update_metric(metric, batch.label)
            nll.append((t, word_lm_nll(mod, batch)))
            if step < LM_CPU_STEPS:
                cpu_checks.append(word_lm_cpu_step(torch, np, mx, mod, full,
                                                   adam, pre, batch))
            step += 1
        ppl.append(metric.get()[1])
    del full, adam
    on_card = mod._buckets[max(LM_BUCKETS)]._execs[0].arg_dict[
        "embed_weight"]._data.is_cuda
    s_check(on_card, "s1 the parameters live on the card")
    s_check(n_params > 13e6, f"s1 {n_params} parameters (the tied 650-d "
            "LM's ~13.3 M)")
    s_check(gens == {t: 1 for t in LM_BUCKETS},
            f"s1 every bucket bound once: {dict(sorted(gens.items()))}")
    mods = [mod._buckets[t] for t in LM_BUCKETS]
    shared = all(
        len({m._execs[0].arg_dict[n]._data.data_ptr() for m in mods}) == 1
        and len({m._execs[0].grad_dict[n]._data.data_ptr()
                 for m in mods}) == 1
        for n in mods[0]._param_names)
    s_check(shared, f"s1 the {len(mods)} buckets read the same parameter "
            f"and gradient tensors ({len(mods[0]._param_names)} names, "
            "data_ptr)")
    s_check(ppl[-1] <= 0.5 * ppl[0], f"s1 perplexity by sweep "
            f"{[round(p, 3) for p in ppl]}: the last at most half the "
            "first")
    log(f"[s1] (bucket, mean NLL) by step: "
        f"{[(t, round(v, 3)) for t, v in nll]}")
    buckets = [t for t, _, _ in sweeps[0][:LM_CPU_STEPS]]
    fmt = lambda d: {k: float(f"{v:.3e}") for k, v in d.items()}  # noqa
    sizes = {k: int(v.size) for k, v in init.items()}
    for i, c in enumerate(cpu_checks):
        what = (f"s1 step {i + 1} (bucket {buckets[i]}) from the card's "
                "weights and Adam states before it, card vs CPU")
        s_check(max(c["grads"].values()) <= LM_CPU_TOL,
                f"{what}: gradients {fmt(c['grads'])} of max|grad| (tol "
                f"{LM_CPU_TOL:g})")
        worst = max(max(c[p].values())
                    for p in ("adam_weights", "adam_m", "adam_v"))
        s_check(worst <= LM_CPU_TOL,
                f"{what}, Adam on the card's gradients: weights "
                f"{fmt(c['adam_weights'])} of max|w|, m {fmt(c['adam_m'])}, "
                f"v {fmt(c['adam_v'])} of their max (tol {LM_CPU_TOL:g})")
        s_check(max(c["weights_kept"].values()) <= LM_CPU_TOL,
                f"{what}, the whole step: weights {fmt(c['weights_kept'])} "
                f"of max|w| (tol {LM_CPU_TOL:g}) where the step's gradient "
                f"difference cannot move Adam's update by the tolerance; "
                f"left out {c['left_out']} of {sizes}; over every element "
                f"{fmt(c['weights_all'])}")
    med = {t: sorted(v)[len(v) // 2] for t, v in step_ms.items()}
    tps = {t: LM_BATCH * t / (med[t] / 1e3) for t in LM_BUCKETS}
    bound = {t: word_lm_flops(t) / PEAK_FP32_FMA_FLOPS * 1e3
             for t in LM_BUCKETS}
    for t in LM_BUCKETS:
        log(f"[s1] bucket {t}: median step {med[t]:.3f} ms over "
            f"{len(step_ms[t])} steps (host clock, forward + backward + "
            f"Adam, synchronised), {tps[t]:.1f} tokens/s; first step "
            f"{first_ms[t]:.3f} ms (its bind included); fp32 FLOP bound "
            f"{bound[t]:.3f} ms ({word_lm_flops(t) / 1e12:.4f} TFLOP)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[s1] peak memory {peak:.3f} GiB")

    keys = list(LM_BUCKETS)
    descs = {t: ([mx.io.DataDesc("data", (LM_BATCH, t))],
                 [mx.io.DataDesc("softmax_label", (LM_BATCH, t))])
             for t in keys}
    t0 = time.perf_counter()
    for i in range(S_SWITCHES):
        mod.switch_bucket(keys[i % len(keys)], *descs[keys[i % len(keys)]])
    switch_ms = (time.perf_counter() - t0) * 1e3 / S_SWITCHES
    log(f"[s1] a bucket switch: {switch_ms * 1e3:.3f} us (host clock, "
        f"mean of {S_SWITCHES}; no bytes move)")

    t_last, x, y = next(b for b in sweeps[-1] if b[0] == max(LM_BUCKETS))
    batch = word_lm_batch(mx, t_last, x, y)
    prof = profile_window(
        torch, lambda: word_lm_step(mod, batch),
        f"one bucket-{t_last} step (forward, backward, Adam)", "s1",
        ("gemm", "nvjet", "cutlass", "xmma", "sm90"), top=10)
    return {"perplexity_by_sweep": ppl, "nll_by_step": nll,
            "buckets_bound": gens,
            "params": int(n_params), "cpu_checks": cpu_checks,
            "median_step_ms": med, "tokens_per_s": tps,
            "first_step_ms": first_ms, "step_ms": step_ms,
            "flop_bound_ms": bound, "peak_gib": peak,
            "switch_ms": switch_ms, "profile": prof}


def word_lm_ulp_grads(np, mx, mod, w, batch, seed):
    """{name: max|dg| / max|g|} between ``mod``'s gradients on ``batch`` at
    the weights ``w`` and at ``w`` moved by one float32 ulp an element in
    seeded random directions: how far float noise alone moves them."""
    rng = np.random.RandomState(seed)
    grads = []
    for ws in (w, {k: np.where(rng.rand(*v.shape) < 0.5,
                               np.nextafter(v, -np.inf),
                               np.nextafter(v, np.inf)).astype(v.dtype)
                   for k, v in w.items()}):
        mod.set_params({k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in ws.items()}, {})
        mod.forward(batch, is_train=True)
        mod.backward()
        grads.append(word_lm_grads(mod))
    return word_lm_rel(np, grads[1], grads[0])


def word_lm_perplexities(torch, mx, n_sweeps):
    """``--lm-sweeps N``: s1's word LM trained over N sweeps of its buckets
    on the card and on a CPU copy from one start, in step; each one's NLL
    by step and perplexity by sweep logged, and every step of the card's
    held as s1 holds its first 3 (word_lm_cpu_step), its gradients where
    one ulp of the weights does not move the CPU's own past the tolerance:
    whether the two courses part because a step on the card is wrong or
    because the function amplifies float noise there."""
    import numpy as np

    _S_FAILED.clear()
    sweeps = word_lm_sweeps(n_sweeps=n_sweeps)
    card = word_lm_module(mx, mx.gpu(0))[0]
    init = {k: mx.nd.array(v.asnumpy(), ctx=mx.cpu())
            for k, v in card.get_params()[0].items()}
    cpu, full, adam = (word_lm_module(mx, mx.cpu(), init)[0]
                       for _ in range(3))
    ppl, nll, worst, unjudged = {"card": [], "cpu": []}, [], {}, []
    parts = ("grads", "adam_weights", "adam_m", "adam_v", "weights_kept")
    for sweep in sweeps:
        metrics = {k: mx.metric.Perplexity(ignore_label=None) for k in ppl}
        for t, x, y in sweep:
            batch = word_lm_batch(mx, t, x, y)
            pre = word_lm_pre(card)
            step = {}
            for name, mod in (("card", card), ("cpu", cpu)):
                word_lm_step(mod, batch)
                mod.update_metric(metrics[name], batch.label)
                step[name] = word_lm_nll(mod, batch)
            c = word_lm_cpu_step(torch, np, mx, card, full, adam, pre, batch)
            errs = {p: max(c[p].values()) for p in parts}
            if errs["grads"] > LM_CPU_TOL:
                # judged only where the CPU's own gradients hold still
                # under one ulp of its weights: else no answer at this
                # tolerance can be told right from wrong
                ulp = word_lm_ulp_grads(np, mx, full, pre[0], batch,
                                        len(nll))
                fmt = lambda d: {k: float(f"{v:.3e}")  # noqa
                                 for k, v in d.items()}
                log(f"[lm-sweeps] step {len(nll) + 1}: the card's gradients "
                    f"vs the CPU's {fmt(c['grads'])}; the CPU's own, its "
                    f"weights moved one ulp: {fmt(ulp)}")
                if max(ulp.values()) > LM_CPU_TOL:
                    unjudged.append(len(nll) + 1)
                    errs["grads"] = 0.0
            for p in parts:
                worst[p] = max(worst.get(p, 0.0), errs[p])
            nll.append((t, step["card"], step["cpu"]))
            log(f"[lm-sweeps] step {len(nll)} bucket {t}: NLL card "
                f"{step['card']:.4f} cpu {step['cpu']:.4f}; the card's step "
                f"vs the CPU from its state: "
                f"{ {p: float(f'{v:.3e}') for p, v in errs.items()} }")
        for name in ppl:
            ppl[name].append(metrics[name].get()[1])
    for name in ppl:
        log(f"[lm-sweeps] {name}: perplexity by sweep "
            f"{[round(p, 3) for p in ppl[name]]}")
    s_check(max(worst.values()) <= LM_CPU_TOL,
            f"lm-sweeps every step of the card's vs the CPU from its state, "
            f"worst {worst} (tol {LM_CPU_TOL:g}); the gradients of steps "
            f"{unjudged} not judged (one ulp moves the CPU's own past the "
            "tolerance)")
    if _S_FAILED:
        raise SystemExit("lm-sweeps: " + "; ".join(_S_FAILED))
    return {"perplexity_by_sweep": ppl, "nll_by_step": nll, "worst": worst,
            "unjudged": unjudged}


def rnn_op_alone(torch, mx):
    """s2: the RNN op at s1's bucket-60 shape ((60, 32, 650), 2 LSTM
    layers): forward and forward + backward, host ms, device ms (the call
    captured as a CUDA graph and replayed back to back) and one profiled
    call's busy time and launches; torch.nn.LSTM (cuDNN) on the same
    weights and input beside it, its output within 1e-4 of max|out|."""
    from mxnet_tpu_torch.ops import rnn as rnn_op

    t, n, h, layers = max(LM_BUCKETS), LM_BATCH, LM_UNITS, LM_LAYERS
    gen = torch.Generator(device="cuda").manual_seed(23)
    flat = torch.rand(rnn_op.rnn_param_size(h, h, layers, False, "lstm"),
                      device="cuda", generator=gen) * 0.14 - 0.07
    x, dout = (torch.randn(t, n, h, device="cuda", generator=gen)
               for _ in range(2))
    h0, c0 = (torch.randn(layers, n, h, device="cuda", generator=gen) * 0.1
              for _ in range(2))
    lstm = torch.nn.LSTM(h, h, num_layers=layers).cuda()
    ws = rnn_op._unpack(flat, h, h, layers, 1, "lstm")
    with torch.no_grad():
        for i in range(layers):
            for name, w in zip(("weight_ih", "weight_hh", "bias_ih",
                                "bias_hh"), ws[i][0]):
                getattr(lstm, f"{name}_l{i}").copy_(w)

    def op_fwd():
        return rnn_op._rnn(x, flat, h0, c0, state_size=h, num_layers=layers,
                           mode="lstm")

    def op_fwd_bwd():
        xg, fg = x.detach().requires_grad_(), flat.detach().requires_grad_()
        rnn_op._rnn(xg, fg, h0, c0, state_size=h, num_layers=layers,
                    mode="lstm").backward(dout)

    def lib_fwd():
        return lstm(x, (h0, c0))[0]

    def lib_fwd_bwd():
        lstm(x.detach().requires_grad_(), (h0, c0))[0].backward(dout)

    with torch.no_grad():
        err = rel_err(op_fwd(), lib_fwd())
    s_check(err <= S_CUDNN_TOL, f"s2 the op vs torch.nn.LSTM (cuDNN) on the "
            f"same weights: {err:.3e} of max|out| (tol {S_CUDNN_TOL:g})")
    out = {"shape": [t, n, h], "layers": layers, "cudnn_err": err}
    for name, fn, grad in (("op_fwd", op_fwd, False),
                           ("op_fwd_bwd", op_fwd_bwd, True),
                           ("cudnn_fwd", lib_fwd, False),
                           ("cudnn_fwd_bwd", lib_fwd_bwd, True)):
        with torch.set_grad_enabled(grad):
            host = median_ms(fn, n=10)
            dev = graph_ms(torch, fn, "s2")
            prof = profile_window(torch, fn, f"one {name} call", "s2",
                                  ("gemm", "nvjet", "cutlass", "xmma",
                                   "sm90", "RNN", "LSTM"), top=5)
        out[name] = {"host_ms": host, "device_ms": dev,
                     "busy_ms": prof["device_busy_ms"],
                     "launches": prof["launches"], "top": prof["top"]}
        log(f"[s2] {name}: {host:.3f} ms a call (CUDA events around one "
            f"call, the host's enqueue), device "
            f"{'not measured' if dev is None else f'{dev:.3f} ms'} (one "
            f"call as a CUDA graph, replayed), {prof['launches']} launches, "
            f"busy {prof['device_busy_ms']:.3f} ms")
    return out


def _copy_params(src, dst):
    """``src``'s parameter values into ``dst``'s, in order (the names'
    counters differ)."""
    import numpy as np

    vals = [np.ascontiguousarray(p.data().detach().cpu().numpy())
            for p in src._param_objects().values()]
    dst.load_numpy_params(dict(zip(dst._param_objects(), vals)))


def gluon_rnn_on_card(torch, mx):
    """s3: gluon.rnn.LSTM(650, 2, input_size=650) against the op on its
    own flat parameters (outputs and every gradient within 1e-5); GRU,
    bidirectional and the cells' unroll at a small width on the card
    against the CPU; five gluon.Trainer steps with clip_global_norm."""
    from mxnet_tpu_torch.gluon import nn, rnn
    from mxnet_tpu_torch.ops import rnn as rnn_op

    t, n, h, layers = max(LM_BUCKETS), LM_BATCH, LM_UNITS, LM_LAYERS
    gen = torch.Generator(device="cuda").manual_seed(29)
    layer = rnn.LSTM(h, layers, input_size=h)
    layer.initialize(mx.init.Xavier(), ctx=mx.gpu(0), generator=gen)
    x, dout = (torch.randn(t, n, h, device="cuda", generator=gen)
               for _ in range(2))
    with mx.autograd.record():
        out = layer(x)
    out.backward(dout)
    flat = layer._flat_params().detach().requires_grad_()
    zeros = torch.zeros(layers, n, h, device="cuda")
    ref = rnn_op._rnn(x, flat, zeros, zeros, state_size=h,
                      num_layers=layers, mode="lstm")
    ref.backward(dout)
    p = layer._param_objects()
    grads = torch.cat([p[layer.prefix + k].grad().reshape(-1)
                       for k in layer._names if k.endswith("weight")] +
                      [p[layer.prefix + k].grad()
                       for k in layer._names if k.endswith("bias")])
    errs = {"out": rel_err(out.detach(), ref.detach()),
            "grads": rel_err(grads, flat.grad)}
    s_check(max(errs.values()) <= S_GLUON_TOL,
            f"s3 gluon.rnn.LSTM({h}, {layers}) vs the op on its flat "
            f"parameters: {errs} (tol {S_GLUON_TOL:g})")

    import numpy as np

    def stacked():
        cell = rnn.SequentialRNNCell()
        cell.add(rnn.LSTMCell(6, input_size=8))
        cell.add(rnn.GRUCell(4, input_size=6))
        return cell

    rs = np.random.RandomState(0)
    xs = rs.rand(5, 3, 8).astype(np.float32)
    vl = np.array([5, 2, 4], np.float32)
    small = (
        ("GRU(6, 2, bidirectional)", lambda: rnn.GRU(
            6, 2, bidirectional=True, input_size=8),
         lambda b, x, v: b(x)),
        ("LSTMCell unroll, valid_length", lambda: rnn.LSTMCell(
            6, input_size=8),
         lambda b, x, v: b.unroll(5, x, layout="TNC", merge_outputs=True,
                                  valid_length=v)[0]),
        ("BidirectionalCell(GRUCell) unroll, valid_length",
         lambda: rnn.BidirectionalCell(rnn.GRUCell(6, input_size=8),
                                       rnn.GRUCell(6, input_size=8)),
         lambda b, x, v: b.unroll(5, x, layout="TNC", merge_outputs=True,
                                  valid_length=v)[0]),
        ("SequentialRNNCell(LSTMCell, GRUCell) unroll NTC", stacked,
         lambda b, x, v: b.unroll(3, x.transpose(0, 1), layout="NTC",
                                  merge_outputs=True)[0]))
    small_errs = {}
    for name, make, run in small:
        host, card = make(), make()
        host.initialize(ctx=mx.cpu())
        card.initialize(ctx=mx.gpu(0))
        _copy_params(host, card)
        got = run(card, torch.tensor(xs, device="cuda"),
                  torch.tensor(vl, device="cuda"))
        want = run(host, torch.tensor(xs), torch.tensor(vl))
        s_check(got.is_cuda, f"s3 {name} ran on the card")
        small_errs[name] = rel_err(got.cpu(), want)
        s_check(small_errs[name] <= S_CARD_TOL, f"s3 {name}: card vs cpu "
                f"{small_errs[name]:.3e} of max|cpu| (tol {S_CARD_TOL:g})")

    class TinyLM(mx.gluon.Block):
        def __init__(self, vocab, units):
            super().__init__()
            with self.name_scope():
                self.emb = nn.Embedding(vocab, units)
                self.rnn = rnn.LSTM(units, 2, input_size=units)
                self.out = nn.Dense(vocab, in_units=units, flatten=False)

        def forward(self, ids):
            hs = self.rnn(self.emb(ids).transpose(0, 1)).transpose(0, 1)
            return self.out(hs)

    vocab = 1000
    net = TinyLM(vocab, 128)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0), generator=gen)
    ids = torch.randint(0, vocab, (16, 21), device="cuda", generator=gen)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 0.01})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, norms = [], []
    for _ in range(5):
        with mx.autograd.record():
            loss = loss_fn(net(ids[:, :-1]), ids[:, 1:]).mean()
        loss.backward()
        norms.append(mx.gluon.utils.clip_global_norm(
            [p.grad() for p in net._param_objects().values()], 1.0))
        trainer.step(1)
        losses.append(float(loss.detach()))
    s_check(losses[-1] < losses[0] and all(np.isfinite(norms)),
            f"s3 five gluon.Trainer steps with clip_global_norm(1.0): loss "
            f"{[round(v, 4) for v in losses]}, norms before the clip "
            f"{[round(v, 3) for v in norms]}")
    return {"lstm_vs_op": errs, "small": small_errs, "trainer_losses": losses,
            "clip_norms": norms}


def foreach_lstm_graph(mx, n, i, h):
    """A foreach whose body is an LSTM step written with sym ops over the
    flat vector's slices, and sym.RNN on the same vector: (loop, fused)."""
    sym = mx.sym
    data, flat = sym.Variable("data"), sym.Variable("params")
    h0, c0 = sym.Variable("h0"), sym.Variable("c0")
    g4 = 4 * h
    end = g4 * (i + h) + 2 * g4
    w_i2h = sym.slice_axis(flat, axis=0, begin=0, end=g4 * i).reshape(
        (g4, i))
    w_h2h = sym.slice_axis(flat, axis=0, begin=g4 * i,
                           end=g4 * (i + h)).reshape((g4, h))
    b = sym.slice_axis(flat, axis=0, begin=g4 * (i + h),
                       end=g4 * (i + h) + g4) + \
        sym.slice_axis(flat, axis=0, begin=g4 * (i + h) + g4, end=end)

    def step(x, states):
        hh, cc = states
        z = sym.FullyConnected(x, w_i2h, b, num_hidden=g4) + \
            sym.FullyConnected(hh, w_h2h, num_hidden=g4, no_bias=True)
        ig, fg, gg, og = sym.SliceChannel(z, num_outputs=4)
        cc = sym.sigmoid(fg) * cc + sym.sigmoid(ig) * sym.tanh(gg)
        hh = sym.sigmoid(og) * sym.tanh(cc)
        return hh, [hh, cc]

    outs, (h_t, c_t) = sym.contrib.foreach(
        step, data, [sym.reshape(h0, shape=(n, h)),
                     sym.reshape(c0, shape=(n, h))])
    fused = sym.RNN(data, flat, h0, c0, state_size=h, mode="lstm",
                    state_outputs=True, name="fused")
    return sym.Group([outs, h_t, c_t]), fused, end


def _bind_grads(mx, s, ctx, args, heads):
    """Outputs and gradients of ``s`` bound on ``ctx`` (grad_req write)."""
    arrays = {k: mx.nd.array(v, ctx=ctx) for k, v in args.items()}
    grads = {k: mx.nd.zeros(v.shape, ctx=ctx) for k, v in args.items()}
    ex = s.bind(ctx, arrays, args_grad=grads, grad_req="write")
    outs = ex.forward(is_train=True)
    ex.backward([mx.nd.array(v, ctx=ctx) for v in heads])
    return ([o._data.detach() for o in outs],
            {k: g._data for k, g in grads.items()})


def control_flow_on_card(torch, mx):
    """s4: a sym.contrib.foreach over an LSTM step against the fused op
    (forward and gradients); while_loop's zero padding and cond's two
    branches; a Predictor over a graph holding _while_loop refuses to
    capture it."""
    import numpy as np

    from mxnet_tpu_torch import capture

    t, n, i, h = 20, LM_BATCH, 64, 64
    loop, fused, size = foreach_lstm_graph(mx, n, i, h)
    rs = np.random.RandomState(0)
    args = {"data": rs.randn(t, n, i).astype(np.float32),
            "params": (rs.randn(size) * 0.1).astype(np.float32),
            "h0": rs.randn(1, n, h).astype(np.float32),
            "c0": rs.randn(1, n, h).astype(np.float32)}
    heads = [rs.randn(t, n, h).astype(np.float32),
             rs.randn(n, h).astype(np.float32),
             rs.randn(n, h).astype(np.float32)]
    l_out, l_g = _bind_grads(mx, loop, mx.gpu(0), args, heads)
    f_out, f_g = _bind_grads(mx, fused, mx.gpu(0), args,
                             [heads[0], heads[1][None], heads[2][None]])
    errs = {"out": max(rel_err(a.reshape(b.shape), b)
                       for a, b in zip(l_out, f_out)),
            **{f"d{k}": rel_err(l_g[k], f_g[k]) for k in args}}
    s_check(all(o.is_cuda for o in l_out),
            "s4 the foreach ran on the card")
    s_check(max(errs.values()) <= S_CARD_TOL,
            f"s4 foreach over an LSTM step vs the fused op ({t}, {n}, {i}) "
            f"H {h}: {errs} (tol {S_CARD_TOL:g} of max|ref|)")

    sym = mx.sym
    outs, (fi, fs) = sym.contrib.while_loop(
        lambda a, s: a < 3.0, lambda a, s: (s * 2, (a + 1.0, s + 1.0)),
        (sym.Variable("i0"), sym.Variable("s0")), max_iterations=5)
    ex = sym.Group([outs, fi, fs]).bind(
        mx.gpu(0), {"i0": mx.nd.zeros((1,), ctx=mx.gpu(0)),
                    "s0": mx.nd.ones((1,), ctx=mx.gpu(0))})
    got = [o.asnumpy().ravel().tolist() for o in ex.forward()]
    s_check(got == [[2, 4, 6, 0, 0], [3], [4]],
            f"s4 while_loop on the card: {got} (2, 4, 6 then two zero rows)")
    picks = []
    for pv in (1.0, 0.0):
        a = sym.Variable("a")
        c = sym.contrib.cond(sym.sum(sym.Variable("p")), lambda: a * 2,
                             lambda: a * 3)
        e = c.bind(mx.gpu(0), {"p": mx.nd.array([pv], ctx=mx.gpu(0)),
                               "a": mx.nd.ones((2,), ctx=mx.gpu(0))})
        picks.append(e.forward()[0].asnumpy().tolist())
    s_check(picks == [[2, 2], [3, 3]], f"s4 cond's branches on the card: "
            f"{picks}")
    refused = None
    try:
        mx.serving.Predictor(outs, {"s0": np.ones((1,), np.float32)},
                             ctx=mx.gpu(0), input_names=("i0",),
                             input_shapes={"i0": ()}, warmup=False)
    except capture.CaptureError as e:
        refused = str(e)
    s_check(refused is not None and "_while_loop" in refused,
            f"s4 a Predictor over a _while_loop graph refuses to capture "
            f"it: {refused!r}")
    return {"foreach_vs_fused": errs, "while_loop": got, "cond": picks}


def sequential_on_card(torch, mx):
    """s5: SequentialModule of a FullyConnected Module and a
    PythonLossModule head (tests/test_control_flow_bucketing.py:182's
    net), 6 SGD steps on the card and on the CPU from one start: outputs
    and parameters within 1e-5 of max|ref|."""
    import numpy as np

    def make(ctx, arg=None):
        sym = mx.sym
        net = sym.FullyConnected(sym.Variable("data"), num_hidden=4,
                                 name="fc")
        body = mx.mod.Module(net, data_names=("data",), label_names=None,
                             context=ctx)
        smod = mx.mod.SequentialModule()
        smod.add(body).add(mx.mod.PythonLossModule(
            data_names=("fc_output",)), take_labels=True)
        smod.bind([mx.io.DataDesc("data", (6, 8))],
                  [mx.io.DataDesc("softmax_label", (6,))])
        if arg is None:
            mx.random.seed(0)
            smod.init_params(mx.initializer.Xavier())
        else:
            smod.init_params(arg_params=arg)
        smod.init_optimizer(optimizer="sgd",
                            optimizer_params={"learning_rate": 0.5})
        return smod

    card = make(mx.gpu(0))
    init = {k: v.asnumpy() for k, v in card.get_params()[0].items()}
    host = make(mx.cpu(), {k: mx.nd.array(v, ctx=mx.cpu())
                           for k, v in init.items()})
    rng = np.random.RandomState(0)
    worst = 0.0
    for _ in range(6):
        x = rng.rand(6, 8).astype(np.float32)
        y = x[:, :4].argmax(1).astype(np.float32)
        outs = []
        for mod in (card, host):
            mod.forward(mx.io.DataBatch(
                data=[mx.nd.array(x, ctx=mx.cpu())],
                label=[mx.nd.array(y, ctx=mx.cpu())]), is_train=True)
            outs.append(mod.get_outputs()[0]._data)
            mod.backward()
            mod.update()
        worst = max(worst, rel_err(outs[0].cpu(), outs[1]))
        for k, v in host.get_params()[0].items():
            worst = max(worst, rel_err(card.get_params()[0][k]._data, v._data))
    s_check(outs[0].is_cuda, "s5 the body Module ran on the card")
    s_check(worst <= S_CARD_TOL, f"s5 SequentialModule + PythonLossModule, "
            f"6 SGD steps: card vs cpu {worst:.3e} of max|cpu| (tol "
            f"{S_CARD_TOL:g})")
    return {"card_vs_cpu": worst}


def rnn_phase(torch, mx):
    """Phase s: the word-LM slice on the card (s1-s5); its checks collect
    failures and the phase fails at its end naming them all."""
    _S_FAILED.clear()
    train = word_lm_train(torch, mx)
    op = rnn_op_alone(torch, mx)
    gluon = gluon_rnn_on_card(torch, mx)
    flow = control_flow_on_card(torch, mx)
    seq = sequential_on_card(torch, mx)
    if _S_FAILED:
        raise SystemExit("phase s: " + "; ".join(_S_FAILED))
    return {"word_lm": train, "rnn_op": op, "gluon": gluon,
            "control_flow": flow, "sequential": seq}

# -------------------------------------------------------------- phase t
# examples/ssd/train_ssd.py's configuration (t1), kept here as the
# script's own copy: 3 classes, 48 synthetic 64x64 images with one box
# each, ImageDetIter (shuffle, rand_mirror), batch 8, 5 epochs, Adam 0.002,
# SoftmaxCrossEntropyLoss(axis=1) + smooth-L1, MultiBoxDetection nms_topk 50
SSD_CLASSES, SSD_IMAGES, SSD_SIZE = 3, 48, 64
SSD_BATCH, SSD_EPOCHS, SSD_LR, SSD_NMS_TOPK = 8, 5, 0.002, 50
SSD_CPU_STEPS = 3       # steps held to a CPU copy from the card's state
SSD_CPU_TOL = 1e-4      # loss and gradients, of max|.| (cuDNN vs CPU convs)
SSD_ADAM_TOL = 1e-5     # Adam on the card's gradients, of max|w|
SSD_DIR = os.path.join(ROOT, "_ssd")      # gitignored: the JPEGs
# SSD300-VGG16's anchor layout (MXNet 1.6 example/ssd, vgg16_reduced at
# 300): feature maps and their sizes, ratios and steps (t2)
SSD300_MAPS = (38, 19, 10, 5, 3, 1)
SSD300_SIZES = ((0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
                (0.71, 0.79), (0.88, 0.961))
SSD300_RATIOS = ((1, 2, 0.5), (1, 2, 0.5, 3, 1 / 3), (1, 2, 0.5, 3, 1 / 3),
                 (1, 2, 0.5, 3, 1 / 3), (1, 2, 0.5), (1, 2, 0.5))
SSD300_STEPS = (8, 16, 32, 64, 100, 300)
SSD300_BATCH, SSD300_CLASSES, SSD300_MAX_GT = 32, 21, 8
SSD300_NMS_TOPK, SSD300_NMS = 400, 0.45
SSD300_TOL = 1e-5       # loc targets and boxes (log / exp), of max|ref|

_T_FAILED = []


def t_check(ok, what):
    """Log a phase-t check; a failed one is collected and fails the phase
    at its end."""
    log(f"[t] {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        _T_FAILED.append(what)
    return ok


def ssd_synthetic(n, size, root=None):
    """train_ssd.py's synthetic_dataset: (entries [(label rows, file)],
    {file: (size, size, 3) uint8 image}); the JPEGs written under ``root``
    when given (PIL)."""
    import numpy as np

    entries, images = [], {}
    rng = np.random.RandomState(0)
    for i in range(n):
        cls = i % SSD_CLASSES
        img = np.full((size, size, 3), 30, np.uint8)
        x0, y0 = rng.randint(4, size // 2, 2)
        w, h = rng.randint(size // 4, size // 2, 2)
        img[y0:y0 + h, x0:x0 + w] = 80 + 60 * cls
        name = f"d{i}.jpg"
        images[name] = img
        if root is not None:
            from PIL import Image

            Image.fromarray(img).save(os.path.join(root, name))
        entries.append((np.array([[cls, x0 / size, y0 / size,
                                   min(1, (x0 + w) / size),
                                   min(1, (y0 + h) / size)]], np.float32),
                        name))
    return entries, images


def ssd_net(mx, num_classes):
    """train_ssd.py's SSD, its class body as written (a HybridBlock of the
    user's, so on mx.nd arrays its hybrid_forward gets F = mx.nd)."""
    gluon = mx.gluon

    class SSD(gluon.HybridBlock):
        """Two feature scales, each with anchors + class/box heads."""

        def __init__(self, num_classes):
            super().__init__()
            self.nc = num_classes
            self.base = gluon.nn.HybridSequential()
            self.base.add(gluon.nn.Conv2D(32, 3, strides=2, padding=1,
                                          activation="relu"),
                          gluon.nn.Conv2D(32, 3, strides=2, padding=1,
                                          activation="relu"))
            self.down = gluon.nn.Conv2D(64, 3, strides=2, padding=1,
                                        activation="relu")
            self.cls1 = gluon.nn.Conv2D(4 * (num_classes + 1), 3, padding=1)
            self.loc1 = gluon.nn.Conv2D(4 * 4, 3, padding=1)
            self.cls2 = gluon.nn.Conv2D(4 * (num_classes + 1), 3, padding=1)
            self.loc2 = gluon.nn.Conv2D(4 * 4, 3, padding=1)

        def hybrid_forward(self, F, x):
            f1 = self.base(x)
            f2 = self.down(f1)
            a1 = F.contrib.MultiBoxPrior(f1, sizes=(0.2, 0.35),
                                         ratios=(1, 2, 0.5))
            a2 = F.contrib.MultiBoxPrior(f2, sizes=(0.5, 0.7),
                                         ratios=(1, 2, 0.5))

            def heads(f, cls, loc):
                cp = cls(f).transpose((0, 2, 3, 1)).reshape(
                    (0, -1, self.nc + 1))
                lp = loc(f).transpose((0, 2, 3, 1)).reshape((0, -1))
                return cp, lp
            c1, l1 = heads(f1, self.cls1, self.loc1)
            c2, l2 = heads(f2, self.cls2, self.loc2)
            anchors = F.Concat(a1, a2, dim=1)
            cls_pred = F.Concat(c1, c2, dim=1).transpose((0, 2, 1))
            loc_pred = F.Concat(l1, l2, dim=1)
            return anchors, cls_pred, loc_pred

    return SSD(num_classes)


class VOC07MApMetric:
    """examples/ssd/eval_metric.py's VOC07MApMetric (11-point AP): each
    detection matches its best-IoU ground truth of its class; a second
    detection on a matched gt is a false positive."""

    def __init__(self, iou_thresh=0.5):
        self.iou_thresh = iou_thresh
        self.records, self.gt_count = {}, {}

    def update(self, labels, preds):
        import numpy as np

        labels, preds = labels.asnumpy(), preds.asnumpy()
        for b in range(preds.shape[0]):
            gts = labels[b][labels[b][:, 0] >= 0]
            dets = preds[b][preds[b][:, 0] >= 0]
            for c in np.unique(gts[:, 0]).astype(int):
                self.gt_count[c] = self.gt_count.get(c, 0) + \
                    int((gts[:, 0] == c).sum())
            matched = np.zeros(len(gts), bool)
            for d in dets[np.argsort(-dets[:, 1])]:
                c = int(d[0])
                cand = np.where(gts[:, 0] == c)[0]
                tp = 0
                if len(cand):
                    g = gts[cand, 1:5]
                    iw = np.maximum(np.minimum(d[4], g[:, 2]) -
                                    np.maximum(d[2], g[:, 0]), 0)
                    ih = np.maximum(np.minimum(d[5], g[:, 3]) -
                                    np.maximum(d[3], g[:, 1]), 0)
                    inter = iw * ih
                    ious = inter / np.maximum(
                        (d[4] - d[2]) * (d[5] - d[3]) + (g[:, 2] - g[:, 0])
                        * (g[:, 3] - g[:, 1]) - inter, 1e-12)
                    j = int(np.argmax(ious))
                    if ious[j] >= self.iou_thresh and not matched[cand[j]]:
                        matched[cand[j]] = True
                        tp = 1
                self.records.setdefault(c, []).append((float(d[1]), tp))

    def get(self):
        import numpy as np

        aps = []
        for c, n_gt in sorted(self.gt_count.items()):
            recs = sorted(self.records.get(c, []), key=lambda r: -r[0])
            if not recs or n_gt == 0:
                aps.append(0.0)
                continue
            tps = np.cumsum([r[1] for r in recs])
            fps = np.cumsum([1 - r[1] for r in recs])
            recall, precision = tps / n_gt, tps / np.maximum(tps + fps, 1e-12)
            aps.append(sum((precision[recall >= t].max()
                            if (recall >= t).any() else 0.0) / 11.0
                           for t in np.linspace(0, 1, 11)))
        return "mAP", float(np.mean(aps)) if aps else 0.0


def ssd_step(mx, net, trainer, cls_loss, x, label):
    """One train_ssd.py step: forward, targets under autograd.pause, the
    class + box loss, backward, trainer.step. Returns (loss, targets)."""
    with mx.autograd.record():
        anchors, cp, lp = net(x)
        with mx.autograd.pause():
            sm = mx.nd.softmax(cp, axis=1)
            lt, lm, ct = mx.nd.contrib.MultiBoxTarget(
                anchors, label, sm, negative_mining_ratio=3.0)
        loss = (cls_loss(cp, ct).mean() +
                mx.nd.smooth_l1((lp - lt) * lm, scalar=1.0).mean())
    loss.backward()
    trainer.step(x.shape[0])
    return loss, (lt, lm, ct)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


def ssd_cpu_check(torch, mx, step, before, states, x, label, card_net,
                  card_loss, card_targets):
    """A CPU copy of the card's step ``step`` from the card's weights and
    Adam states before it: loss and gradients within SSD_CPU_TOL of max,
    the targets (class targets and masks exactly), then Adam on the card's
    gradients against the card's weights after the step."""
    with mx.cpu():
        net = ssd_net(mx, SSD_CLASSES)
        net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
        net(mx.nd.zeros((1, 3, SSD_SIZE, SSD_SIZE)))
        cpu_params = list(net.collect_params().param_objects.values())
        for p, w in zip(cpu_params, before):
            p.set_data(w)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": SSD_LR})
        trainer.set_states_bytes(states)
        cls_loss = mx.gluon.loss.SoftmaxCrossEntropyLoss(axis=1)
        xc, lc = x.as_in_context(mx.cpu()), label.as_in_context(mx.cpu())
        with mx.autograd.record():
            anchors, cp, lp = net(xc)
            with mx.autograd.pause():
                lt, lm, ct = mx.nd.contrib.MultiBoxTarget(
                    anchors, lc, mx.nd.softmax(cp, axis=1),
                    negative_mining_ratio=3.0)
            loss = (cls_loss(cp, ct).mean() +
                    mx.nd.smooth_l1((lp - lt) * lm, scalar=1.0).mean())
        loss.backward()
        card_params = list(card_net.collect_params().param_objects.values())
        loss_err = abs(float(loss.asnumpy()) - card_loss) / abs(card_loss)
        same_targets = all(torch.equal(a._data.cpu(), b._data) for a, b in
                           zip(card_targets[1:], (lm, ct)))
        lt_err = _rel(card_targets[0]._data.cpu(), lt._data)
        grad_err = max(_rel(cp_.grad().cpu(), p.grad())
                       for cp_, p in zip(card_params, cpu_params))
        for cp_, p in zip(card_params, cpu_params):
            p.grad().copy_(cp_.grad().cpu())
        trainer.step(x.shape[0])
        adam_err = max(_rel(cp_.data().detach().cpu(), p.data().detach())
                       for cp_, p in zip(card_params, cpu_params))
    t_check(loss_err <= SSD_CPU_TOL and grad_err <= SSD_CPU_TOL
            and same_targets and lt_err <= SSD_CPU_TOL
            and adam_err <= SSD_ADAM_TOL,
            f"t1 step {step} vs a CPU copy from the card's state: loss "
            f"{loss_err:.2e}, gradients {grad_err:.2e} of max|g| (tol "
            f"{SSD_CPU_TOL:g}); class targets and masks equal: "
            f"{same_targets}; loc targets {lt_err:.2e}; Adam on the card's "
            f"gradients {adam_err:.2e} of max|w| (tol {SSD_ADAM_TOL:g})")
    return {"loss": loss_err, "grad": grad_err, "loc_target": lt_err,
            "targets_equal": same_targets, "adam": adam_err}


def ssd_train(torch, mx):
    """t1: train_ssd.py's configuration on gpu(0) through ImageDetIter
    (JPEGs written and read through PIL where the machine has it, else
    the same images as arrays through ImageDetIter.decode); 5 epochs,
    loss by epoch (the last below the first); the first SSD_CPU_STEPS
    steps each held to a CPU copy from the card's state; host ms a step,
    images/s, one step profiled (busy share, launches); VOC07 mAP of
    MultiBoxDetection over the set."""
    import importlib.util
    import random
    import shutil

    import numpy as np

    has_pil = importlib.util.find_spec("PIL") is not None
    shutil.rmtree(SSD_DIR, ignore_errors=True)
    os.makedirs(SSD_DIR)
    entries, images = ssd_synthetic(SSD_IMAGES, SSD_SIZE,
                                    SSD_DIR if has_pil else None)
    source = "JPEG files through PIL (imread)" if has_pil else \
        "arrays from the same RandomState(0) through ImageDetIter.decode " \
        "(no PIL on this machine: mx.image.imread raises, as mxnet_tpu's)"
    log(f"[t1] image source: {source}")
    random.seed(0)
    np.random.seed(0)
    torch.manual_seed(0)
    it = mx.image.ImageDetIter(batch_size=SSD_BATCH,
                               data_shape=(3, SSD_SIZE, SSD_SIZE),
                               imglist=entries, path_root=SSD_DIR,
                               shuffle=True, rand_mirror=True)
    if not has_pil:
        def decode(i):
            label, name = it._entries[it._order[i]]
            return images[name].astype(np.float32), label
        it.decode = decode
    net = ssd_net(mx, SSD_CLASSES)
    net.initialize(mx.initializer.Xavier())
    net(mx.nd.zeros((1, 3, SSD_SIZE, SSD_SIZE)))     # the deferred shapes
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": SSD_LR})
    cls_loss = mx.gluon.loss.SoftmaxCrossEntropyLoss(axis=1)
    epoch_loss, step_ms, checks, step = [], [], [], 0
    for epoch in range(SSD_EPOCHS):
        it.reset()
        tot = []
        for batch in it:
            x = batch.data[0] / 255.0
            label = batch.label[0]
            if step < SSD_CPU_STEPS:
                before = [t.detach().cpu().clone()
                          for t in net.collect_params().values()]
                states = trainer.get_states_bytes()
            t0 = time.perf_counter()
            loss, targets = ssd_step(mx, net, trainer, cls_loss, x, label)
            tot.append(float(loss.asnumpy()))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if step < SSD_CPU_STEPS:
                checks.append(ssd_cpu_check(torch, mx, step, before, states,
                                            x, label, net, tot[-1], targets))
            step += 1
        epoch_loss.append(sum(tot) / len(tot))
        log(f"[t1] epoch {epoch}: loss {epoch_loss[-1]:.4f}")
    t_check(x.context == mx.gpu(0) and net.cls1.weight.is_cuda,
            f"t1 the batches and the net on {x.context}")
    t_check(epoch_loss[-1] < epoch_loss[0],
            f"t1 the last epoch's loss {epoch_loss[-1]:.4f} below the "
            f"first's {epoch_loss[0]:.4f}")
    steady = sorted(step_ms[len(step_ms) // SSD_EPOCHS:])
    med = steady[len(steady) // 2]
    metric = VOC07MApMetric(iou_thresh=0.5)
    it.reset()
    kept = None
    for batch in it:
        anchors, cp, lp = net(batch.data[0] / 255.0)
        det = mx.nd.contrib.MultiBoxDetection(
            mx.nd.softmax(cp, axis=1), lp, anchors, nms_topk=SSD_NMS_TOPK)
        metric.update(batch.label[0], det)
        if kept is None:
            k = det.asnumpy()[0]
            kept = k[k[:, 0] >= 0]
    name, value = metric.get()
    t_check(0.0 <= value <= 1.0 and len(kept) > 0,
            f"t1 {name}={value:.4f} (VOC07 11-point, iou 0.5) over the "
            f"{SSD_IMAGES} images after {SSD_EPOCHS} epochs; "
            f"{len(kept)} detections kept on image 0")
    it.reset()
    batch = next(iter(it))
    x, label = batch.data[0] / 255.0, batch.label[0]
    prof = profile_window(
        torch, lambda: float(ssd_step(mx, net, trainer, cls_loss, x,
                                      label)[0].asnumpy()),
        "one SSD training step (forward, targets, loss, backward, Adam)",
        "t1", ("nchwToNhwc", "conv", "cudnn", "xmma", "sm90", "gemm"))
    log(f"[t1] host ms a step (median over epochs 2-{SSD_EPOCHS}, the "
        f"loss read back each step as the example does): {med:.3f}; "
        f"{SSD_BATCH / med * 1e3:.1f} images/s; {prof['launches']} kernel "
        f"launches a step, the card busy "
        f"{prof['device_busy_ms'] / prof['wall_ms']:.1%} of the profiled "
        "step")
    return {"image_source": "pil" if has_pil else "arrays",
            "epoch_loss": epoch_loss, "median_step_ms": med,
            "images_per_s": SSD_BATCH / med * 1e3, "step_ms": step_ms,
            "cpu_checks": checks, "map": value, "profile": prof}


def ssd300_inputs(torch, mx, ctx):
    """SSD300-VGG16's 8732 anchors and a batch of SSD300_BATCH images'
    labels (1-8 boxes each, padded with -1), class probabilities (21
    classes) and box offsets, drawn from a seed, on ``ctx``."""
    import numpy as np

    rng = np.random.RandomState(21)
    anchors = mx.nd.concat(*[
        mx.nd.contrib.MultiBoxPrior(
            mx.nd.zeros((1, 1, m, m), ctx=ctx), sizes=s, ratios=r,
            steps=(st / 300, st / 300))
        for m, s, r, st in zip(SSD300_MAPS, SSD300_SIZES, SSD300_RATIOS,
                               SSD300_STEPS)], dim=1)
    n = anchors.shape[1]
    lab = np.full((SSD300_BATCH, SSD300_MAX_GT, 5), -1, np.float32)
    for i in range(SSD300_BATCH):
        for j in range(rng.randint(1, SSD300_MAX_GT + 1)):
            c = np.sort(rng.rand(2, 2), axis=0)
            lab[i, j] = [rng.randint(0, SSD300_CLASSES - 1), c[0, 0],
                         c[0, 1], c[1, 0], c[1, 1]]
    logits = rng.randn(SSD300_BATCH, SSD300_CLASSES, n).astype(np.float32)
    prob = mx.nd.softmax(mx.nd.array(logits, ctx=ctx), axis=1)
    loc = mx.nd.array(rng.randn(SSD300_BATCH, n * 4).astype(np.float32)
                      * 0.1, ctx=ctx)
    return anchors, mx.nd.array(lab, ctx=ctx), prob, loc


def ssd300_ops(torch, mx):
    """t2: MultiBoxPrior, MultiBoxTarget (negative_mining_ratio 3) and
    MultiBoxDetection (nms_topk 400) at SSD300-VGG16's size on the card,
    each against its CPU run on the same inputs (anchors, class targets,
    masks, class ids, scores and kept rows exactly; loc targets and boxes
    within SSD300_TOL of max|ref|); the device time of its kernels
    (torch.profiler: a call queues too many launches for device_ms's
    spin), host ms and launches of each, and of the NMS sweep alone."""
    from mxnet_tpu_torch.ops import detection

    card = ssd300_inputs(torch, mx, mx.gpu(0))
    host = ssd300_inputs(torch, mx, mx.cpu())
    anchors, label, prob, loc = card
    t_check(anchors.shape == (1, 8732, 4),
            f"t2 SSD300's anchors {anchors.shape} (maps {SSD300_MAPS})")
    t_check(torch.equal(anchors._data.cpu(), host[0]._data),
            "t2 MultiBoxPrior: the card's anchors equal the CPU's")
    t_check(torch.equal(prob._data.cpu(), host[2]._data) or
            _rel(prob._data.cpu(), host[2]._data) <= 1e-6,
            f"t2 the inputs' softmax on the card against the CPU's: "
            f"{_rel(prob._data.cpu(), host[2]._data):.2e} of max")
    # both runs take the CPU's probabilities, so the ops see one input
    prob = mx.nd.array(host[2], ctx=mx.gpu(0))

    def target(a, lab, p):
        return mx.nd.contrib.MultiBoxTarget(a, lab, p,
                                            negative_mining_ratio=3.0)

    def detect(p, lp, a):
        return mx.nd.contrib.MultiBoxDetection(
            p, lp, a, nms_topk=SSD300_NMS_TOPK, nms_threshold=SSD300_NMS)

    got_t, want_t = target(anchors, label, prob), target(*host[:3])
    t_check(all(torch.equal(g._data.cpu(), w._data)
                for g, w in zip(got_t[1:], want_t[1:])) and
            _rel(got_t[0]._data.cpu(), want_t[0]._data) <= SSD300_TOL,
            f"t2 MultiBoxTarget: class targets and masks equal, loc targets "
            f"{_rel(got_t[0]._data.cpu(), want_t[0]._data):.2e} of max "
            f"(tol {SSD300_TOL:g}); "
            f"{int((want_t[2]._data > 0).sum())} positives, "
            f"{int((want_t[2]._data == 0).sum())} mined negatives")
    got_d, want_d = detect(prob, loc, anchors), detect(host[2], host[3],
                                                       host[0])
    g, w = got_d._data.cpu(), want_d._data
    kept = w[..., 0] >= 0
    t_check(torch.equal(g[..., :2], w[..., :2]) and
            _rel(g[..., 2:], w[..., 2:]) <= SSD300_TOL,
            f"t2 MultiBoxDetection: class ids, scores and kept rows equal "
            f"({int(kept.sum())} kept of {SSD300_BATCH} x "
            f"{SSD300_NMS_TOPK}), boxes {_rel(g[..., 2:], w[..., 2:]):.2e} "
            f"of max (tol {SSD300_TOL:g})")
    # the NMS sweep alone, on the detection's own top-400 decoded boxes
    fg = prob._data[:, 1:]
    top = torch.sort(-fg.amax(1), dim=1,
                     stable=True).indices[:, :SSD300_NMS_TOPK]
    decoded = detection._decode_loc(
        loc._data.reshape(SSD300_BATCH, -1, 4), anchors._data.reshape(-1, 4),
        (0.1, 0.1, 0.2, 0.2)).clamp(0.0, 1.0)
    boxes = detection._gather_rows(decoded, top)
    ids = torch.gather(fg.argmax(1).float(), 1, top)
    keep0 = torch.ones(top.shape, dtype=torch.bool, device=top.device)
    feat38 = mx.nd.zeros((1, 1, 38, 38), ctx=mx.gpu(0))
    out = {}
    for name, fn in (
            ("MultiBoxPrior (38 x 38)", lambda: mx.nd.contrib.MultiBoxPrior(
                feat38, sizes=SSD300_SIZES[0], ratios=SSD300_RATIOS[0],
                steps=(8 / 300, 8 / 300))),
            ("MultiBoxTarget", lambda: target(anchors, label, prob)),
            ("MultiBoxDetection", lambda: detect(prob, loc, anchors)),
            ("NMS sweep (K=400)", lambda: detection._nms_sweep(
                boxes, ids, keep0, SSD300_NMS, False))):
        hms = sorted(host_ms(torch, fn, 5))[2]
        prof = profile_window(torch, fn, f"one {name}", "t2",
                              ("sort", "masked_fill"), top=4)
        seen = prof["device_busy_ms"] > 0      # the profiler saw its kernels
        out[name] = {"device_ms": prof["device_busy_ms"] if seen else None,
                     "host_ms": hms,
                     "launches": prof["launches"] if seen else None}
        log(f"[t2] {name} at batch {SSD300_BATCH}, 8732 anchors, "
            f"{SSD300_CLASSES} classes: host {hms:.3f} ms (median of 5, "
            "ended by a synchronise); " + (
                f"device {prof['device_busy_ms']:.3f} ms (its kernels' time, "
                f"torch.profiler) in {prof['launches']} kernel launches"
                if seen else "device time and launches not measured (the "
                "profiler recorded no kernel)"))
    return out


def kernel_launch_total():
    """The launch counts of every kernel wrapper (K1-K5), summed."""
    from mxnet_tpu_torch.ops import decode_attention as da
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops import quantization as q

    return sum(f.launches for f in (
        kernels.flash_attention, kernels.flash_attention_backward,
        kernels.conv3x3_bn_stats, da.paged_decode_attention,
        da.kv_quantize_write, q.s8_conv, q.s8_matmul, q.requant_epilogue,
        q.s8_conv_requant))


def ssd_phase(torch, mx):
    """Phase t: t1 and t2; its checks collect failures and the phase fails
    at its end naming them all."""
    import shutil

    _T_FAILED.clear()
    before = kernel_launch_total()
    try:
        train = ssd_train(torch, mx)
        ops = ssd300_ops(torch, mx)
    finally:
        shutil.rmtree(SSD_DIR, ignore_errors=True)
    t_check(kernel_launch_total() == before,
            f"t K1-K5 launched {kernel_launch_total() - before} times in "
            "phase t (no TPU kernel is on the SSD path)")
    if _T_FAILED:
        raise SystemExit("phase t: " + "; ".join(_T_FAILED))
    return {"train": train, "ssd300": ops}


# -------------------------------------------------------------- phase u
# examples/distributed/cifar10_dist.py's configuration (u1) and BASELINE
# config #5's model, resnet50_v1 through gluon.Trainer(kvstore='dist_sync')
# (u2): DIST_RANKS worker processes started by the port's launcher
# (mxnet_tpu_torch/kvstore/launch.py), sharing the one card over
# gloo (backend_rule: one GPU for two workers)
DIST_RANKS = 2
DIST_DIR = os.path.join(ROOT, "_dist")    # gitignored: the ranks' results
DIST_JOIN_S = 420
U1_EPOCHS, U1_BATCH, U1_LR = 2, 32, 0.002
# the summed gradient against one process's, of max|g|: a conv weight's
# gradient sums 65,536 products in fp32, two halves then their sum against
# one pass (the CPU rehearsal reads 3e-5)
U1_GRAD_TOL = 1e-4
# Adam's first step from them, of max|w|, where the one-process gradient is
# at least U1_GRAD_FLOOR of its max (Adam's first update is +-lr wherever
# |g| >> eps, so a gradient at noise level may take either sign; counted)
U1_ADAM_TOL, U1_GRAD_FLOOR = 1e-5, 1e-3
U2_BATCH, U2_STEPS = 32, 3
U2_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
U_LIVE_CALLS = 200    # calls a median of the liveness costs is taken over
U_LIVE_NUMEL = 158_857    # u2's mean key: 25,575,912 weights in 161 keys


def cifar_net(mx):
    """cifar10_dist.py's net."""
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Conv2D(32, 3, padding=1, activation="relu"),
            mx.gluon.nn.MaxPool2D(2),
            mx.gluon.nn.GlobalAvgPool2D(),
            mx.gluon.nn.Dense(10))
    return net


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _dist_step(torch, mx, net, trainer, loss_fn, x, y):
    """One data-parallel step, split as trainer.step splits it: forward +
    backward, the gradients' all-reduce (push + pull), the update. Returns
    (output, [ms of each part])."""
    def fwd_bwd():
        with mx.autograd.record():
            out = net(x)
            loss = loss_fn(out, y)
        loss.backward()
        return out
    out, t_fb = _timed(torch, fwd_bwd)
    _, t_ar = _timed(torch, trainer.allreduce_grads)
    _, t_up = _timed(torch, lambda: trainer.update(x.shape[0]))
    return out, [t_fb, t_ar, t_up]


def _param_arrays(net):
    """The trainable parameters (BatchNorm's running statistics are each
    rank's own, as MXNet's are), as host arrays in collect_params order."""
    return [p.data().detach().cpu().numpy().copy()
            for p in net.collect_params().param_objects.values()
            if p.grad_req != "null"]


def dist_rank_u1(torch, mx, kv, rank, nw, out_dir):
    """cifar10_dist.py's loop on this rank's shard, each step timed in
    parts; the first step's batch, weights before, summed gradients and
    weights after, and the final parameters saved."""
    import numpy as np

    np.random.seed(rank)
    T = mx.gluon.data.vision.transforms
    transform = T.Compose([T.ToTensor()])
    ds = mx.gluon.data.vision.CIFAR10(train=True).transform_first(transform)
    idx = list(range(rank, len(ds), nw))
    shard = mx.gluon.data.SimpleDataset([ds[i] for i in idx])
    loader = mx.gluon.data.DataLoader(shard, batch_size=U1_BATCH,
                                      shuffle=True)
    mx.random.seed(7)
    torch.manual_seed(7)          # identical init on every rank
    net = cifar_net(mx)
    net.initialize(mx.initializer.Xavier())
    net(mx.nd.zeros((1, 3, 32, 32)))      # the deferred shapes
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": U1_LR}, kvstore=kv)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()
    parts, first = [], {}
    mx.gluon.data.dataloader.reset_stats()
    for epoch in range(U1_EPOCHS):
        metric.reset()
        for x, y in loader:
            if not first:
                first = {"x": x.asnumpy(), "y": y.asnumpy()}
                first.update({f"w0/{i}": w for i, w in
                              enumerate(_param_arrays(net))})
            out, ms = _dist_step(torch, mx, net, trainer, loss_fn, x, y)
            if "w1/0" not in first:
                for i, p in enumerate(
                        net.collect_params().param_objects.values()):
                    first[f"g/{i}"] = p.grad().cpu().numpy().copy()
                first.update({f"w1/{i}": a for i, a in
                              enumerate(_param_arrays(net))})
            parts.append(ms)
            metric.update([y], [out])
        log(f"[u1 rank {rank}] epoch {epoch}: {metric.get()}")
    params = _param_arrays(net)
    checksum = sum(float(a.sum()) for a in params)
    log(f"[u1 rank {rank}] param checksum {checksum:.6f}")
    np.savez(os.path.join(out_dir, f"u1_rank{rank}.npz"), **first,
             **{f"w/{i}": a for i, a in enumerate(params)})
    return {"parts_ms": parts, "checksum": checksum,
            "fingerprint_agree": kv.fingerprint_agree(
                {str(i): a for i, a in enumerate(params)}),
            "loader": mx.gluon.data.dataloader.stats(),
            "batches": len(parts)}


def dist_rank_u2(torch, mx, kv, rank, nw, out_dir):
    """resnet50_v1 (fp32, NCHW, 224^2) through gluon.Trainer(kvstore=kv):
    U2_STEPS SGD steps on this rank's seeded batch, timed in parts; the
    final trainable parameters saved."""
    import numpy as np

    torch.manual_seed(0)
    net = mx.gluon.model_zoo.vision.resnet50_v1()
    net.initialize(mx.initializer.Xavier(rnd_type="gaussian",
                                         factor_type="in", magnitude=2))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(U2_OPT),
                               kvstore="dist_sync")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(100 + rank)
    x = mx.nd.array(rng.rand(U2_BATCH, 3, 224, 224).astype(np.float32))
    y = mx.nd.array(rng.randint(0, 1000, U2_BATCH).astype(np.float32))
    parts = []
    for _ in range(U2_STEPS):
        parts.append(_dist_step(torch, mx, net, trainer, loss_fn, x, y)[1])
    params = _param_arrays(net)
    np.save(os.path.join(out_dir, f"u2_rank{rank}.npy"),
            np.concatenate([a.ravel() for a in params]))
    return {"parts_ms": parts, "n_params": int(sum(a.size for a in params)),
            "checksum": sum(float(a.sum()) for a in params),
            "fingerprint_agree": kv.fingerprint_agree(
                {str(i): a for i, a in enumerate(params)})}


def dist_liveness_us(torch, kv):
    """Median microseconds of the liveness work a dist push does, over
    U_LIVE_CALLS calls each: one ``check_peers`` (the beats cached), one
    beat written, and one scan that reads every peer's beat afresh; and
    of one all-reduce of U_LIVE_NUMEL fp32 on the card through the store
    (the collective guard and the sliced wait) and through
    ``torch.distributed`` alone, in alternating blocks. Every rank calls
    it."""
    import torch.distributed as tdist

    from mxnet_tpu_torch.resilience import watchdog

    def med(fn):
        ts = []
        for _ in range(U_LIVE_CALLS):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
        return sorted(ts)[len(ts) // 2]

    def fresh_scan():
        watchdog._PEER_BEATS.clear()
        watchdog._scan_dead()

    t = torch.zeros(U_LIVE_NUMEL, device="cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(t)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    ar = {"guarded": [], "raw": []}
    for _ in range(U_LIVE_CALLS // 20):
        for name, fn in (("guarded", kv.allreduce),
                         ("raw", tdist.all_reduce)):
            ar[name].extend(timed(fn) for _ in range(10))
    return {"check_peers": med(lambda: watchdog.check_peers("u")),
            "beat_write": med(watchdog.heartbeat),
            "scan_unread": med(fresh_scan),
            **{f"allreduce_{k}": sorted(v)[len(v) // 2]
               for k, v in ar.items()}}


def dist_rank(out_dir):
    """One rank of phase u (a process the launcher started): u1, then u2,
    their results in ``out_dir``/u1_rank<r>.json and u2_rank<r>.json."""
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kvstore import dist

    kv = mx.kv.create("dist_sync")
    rank, nw = kv.rank, kv.num_workers
    if rank == 0:
        log(f"[u] {nw} ranks on {torch.cuda.get_device_name(0)}: backend "
            f"{kv.backend!r} ({dist.backend_rule(nw)[1]})")
    for phase, body in (("u1", dist_rank_u1), ("u2", dist_rank_u2)):
        t0 = time.perf_counter()
        res = body(torch, mx, kv, rank, nw, out_dir)
        kv.barrier()
        res.update({"backend": kv.backend, "num_workers": nw,
                    "wall_s": time.perf_counter() - t0})
        if phase == "u2":
            res["liveness_us"] = dist_liveness_us(torch, kv)
            kv.barrier()
        with open(os.path.join(out_dir, f"{phase}_rank{rank}.json"),
                  "w") as f:
            json.dump(res, f)
    return 0


def _launch_ranks():
    """Start DIST_RANKS ranks of phase u through the port's launcher;
    fails the phase if the job fails or outlasts DIST_JOIN_S. Returns
    ({phase: [each rank's results]}, the job's wall seconds)."""
    # the launcher's file, run as a script: it imports only the standard
    # library, where `-m mxnet_tpu_torch.kvstore.launch` imports the package
    cmd = [sys.executable, os.path.join(ROOT, "mxnet_tpu_torch", "kvstore",
                                        "launch.py"), "-n", str(DIST_RANKS),
           sys.executable, os.path.abspath(__file__), "--dist-rank",
           DIST_DIR]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep +
               os.environ.get("PYTHONPATH", ""),
               MXNET_TPU_TORCH_DIST_CLAIM_DIR=os.path.join(DIST_DIR,
                                                           "claims"))
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, cwd=ROOT, env=env, timeout=DIST_JOIN_S)
    except subprocess.TimeoutExpired:
        raise SystemExit(f"phase u: the ranks did not finish within "
                         f"{DIST_JOIN_S} s")
    if r.returncode != 0:
        raise SystemExit(f"phase u: the job exited {r.returncode}")
    wall = time.perf_counter() - t0
    ranks = {}
    for phase in ("u1", "u2"):
        ranks[phase] = []
        for k in range(DIST_RANKS):
            with open(os.path.join(DIST_DIR, f"{phase}_rank{k}.json")) as f:
                ranks[phase].append(json.load(f))
    return ranks, wall


def _parts_summary(parts, skip):
    """Median ms of the whole step and of each part, over the steps after
    ``skip``, and the all-reduce's share of the step."""
    rows = parts[skip:]
    med = [sorted(r[k] for r in rows)[len(rows) // 2] for k in range(3)]
    step = sorted(sum(r) for r in rows)[len(rows) // 2]
    return {"step_ms": step, "fwd_bwd_ms": med[0], "allreduce_ms": med[1],
            "update_ms": med[2], "allreduce_share": med[1] / step}


_U_FAILED = []


def u_check(ok, what):
    """Log a phase-u check; a failed one is collected and fails the phase
    at its end."""
    log(f"[u] {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        _U_FAILED.append(what)
    return ok


def dist_phase(torch, mx):
    """Phase u: u1 and u2, each DIST_RANKS ranks on this card; the ranks
    end bitwise equal (every trainable parameter), u1's first dist step
    equals one process's step over both shards; step ms and the
    all-reduce's share of it, on 2 ranks on one H100 over gloo."""
    import shutil

    import numpy as np

    _U_FAILED.clear()
    out = {}
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    torch.cuda.empty_cache()
    try:
        job, wall = _launch_ranks()
        ranks = job["u1"]
        where = (f"{DIST_RANKS} ranks on one {torch.cuda.get_device_name(0)}"
                 f" over {ranks[0]['backend']}")
        log(f"[u] the job of {DIST_RANKS} ranks took {wall:.1f} s (u1 "
            f"{ranks[0]['wall_s']:.1f} s, u2 {job['u2'][0]['wall_s']:.1f} s "
            "of it on rank 0)")
        a, b = (np.load(os.path.join(DIST_DIR, f"u1_rank{k}.npz"))
                for k in range(DIST_RANKS))
        n = sum(k.startswith("w/") for k in a.files)
        same = all(np.array_equal(a[f"w/{i}"], b[f"w/{i}"]) for i in range(n))
        u_check(same and ranks[0]["checksum"] == ranks[1]["checksum"]
                and all(r["fingerprint_agree"] for r in ranks),
                f"u1 after {U1_EPOCHS} epochs ({ranks[0]['batches']} steps a "
                f"rank) every parameter bitwise equal across the ranks; "
                f"checksums {[r['checksum'] for r in ranks]}; "
                "fingerprint_agree on every rank")
        # one process over both shards, from the weights before step 1
        net = cifar_net(mx)
        net.initialize(mx.initializer.Xavier())
        x = np.concatenate([a["x"], b["x"]])
        y = np.concatenate([a["y"], b["y"]])
        net(mx.nd.array(x[:1]))
        params = list(net.collect_params().param_objects.values())
        for i, p in enumerate(params):
            p.set_data(a[f"w0/{i}"])
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": U1_LR})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(x)), mx.nd.array(y))
        loss.backward()
        grads = [p.grad().cpu().numpy().copy() for p in params]
        g_err = max(float(np.abs(g - a[f"g/{i}"]).max()
                          / max(np.abs(g).max(), 1e-12))
                    for i, g in enumerate(grads))
        trainer.step(U1_BATCH)
        w_err, noise = 0.0, 0
        for i, (p, g) in enumerate(zip(params, grads)):
            sure = np.abs(g) >= U1_GRAD_FLOOR * np.abs(g).max()
            w = p.data().detach().cpu().numpy()
            w_err = max(w_err, float(np.abs(w - a[f"w1/{i}"])[sure].max(
                initial=0.0) / max(np.abs(w).max(), 1e-12)))
            noise += int((~sure).sum())
        u_check(g_err <= U1_GRAD_TOL and w_err <= U1_ADAM_TOL,
                f"u1 the first dist step against one process's step over "
                f"both shards ({2 * U1_BATCH} samples, rescale 1/"
                f"{U1_BATCH}) from the same weights: summed gradients "
                f"{g_err:.2e} of max|g| (tol {U1_GRAD_TOL:g}), weights after "
                f"Adam {w_err:.2e} of max|w| (tol {U1_ADAM_TOL:g}) where "
                f"|g| >= {U1_GRAD_FLOOR:g} max|g| ({noise} weights below "
                "it not held)")
        s1 = _parts_summary(ranks[0]["parts_ms"], skip=1)
        log(f"[u1] {where}: median step {s1['step_ms']:.3f} ms (forward + "
            f"backward {s1['fwd_bwd_ms']:.3f}, all-reduce "
            f"{s1['allreduce_ms']:.3f}, update {s1['update_ms']:.3f}; the "
            f"all-reduce {s1['allreduce_share']:.1%} of the step), host "
            f"clock, rank 0; {U1_BATCH * DIST_RANKS / s1['step_ms'] * 1e3:.1f}"
            f" images/s over the ranks; the loader's host-to-device copies "
            f"{ranks[0]['loader']}")
        out["u1"] = {"ranks": ranks, "summary": s1,
                     "grad_err": g_err, "weight_err": w_err, "where": where}
        ranks = job["u2"]
        p0, p1 = (np.load(os.path.join(DIST_DIR, f"u2_rank{k}.npy"))
                  for k in range(DIST_RANKS))
        u_check(np.array_equal(p0, p1) and np.isfinite(p0).all()
                and all(r["fingerprint_agree"] for r in ranks),
                f"u2 resnet50_v1 after {U2_STEPS} steps: all "
                f"{ranks[0]['n_params']} trainable weights bitwise equal "
                "across the ranks and finite; fingerprint_agree on every "
                "rank")
        s2 = _parts_summary(ranks[0]["parts_ms"], skip=1)
        log(f"[u2] {where}: resnet50_v1 fp32 batch {U2_BATCH} a rank, "
            f"median step {s2['step_ms']:.3f} ms (forward + backward "
            f"{s2['fwd_bwd_ms']:.3f}, all-reduce {s2['allreduce_ms']:.3f}, "
            f"update {s2['update_ms']:.3f}; the all-reduce "
            f"{s2['allreduce_share']:.1%} of the step), host clock, rank 0, "
            f"steps 2-{U2_STEPS}; "
            f"{U2_BATCH * DIST_RANKS / s2['step_ms'] * 1e3:.1f} images/s over"
            f" the ranks")
        live = ranks[0]["liveness_us"]
        log(f"[u] liveness on rank 0, median of {U_LIVE_CALLS} calls: "
            f"check_peers {live['check_peers']:.1f} us (once a push), a "
            f"beat written {live['beat_write']:.1f} us (once a second), a "
            f"scan reading every beat {live['scan_unread']:.1f} us (once a "
            f"generation); an all-reduce of {U_LIVE_NUMEL} fp32 on the card "
            f"{live['allreduce_guarded']:.1f} us through the store (guard, "
            f"sliced wait), {live['allreduce_raw']:.1f} us through "
            "torch.distributed alone")
        out["u2"] = {"ranks": ranks, "summary": s2, "where": where}
        out["job_wall_s"] = wall
    finally:
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    if _U_FAILED:
        raise SystemExit("phase u: " + "; ".join(_U_FAILED))
    return out



# ------------------------------------------------------------------ phase v
# the serving runtime: a fleet of phase d's LM (v1), a process replica
# (v2), swap_params and rollouts (v3), a {fp32, int8} variant group of
# phase p's ResNet-18 (v4), a StreamRouter of phase n's model (v5)
FLEET_BUCKETS = (1, 2, 4, 8)
FLEET_THREADS, FLEET_PER_THREAD = 4, 32
FLEET_DEADLINE_MS = 60000.0
FLEET_WATCHDOG_S = "0.5"      # the batch deadline of v1's drills
FLEET_HANG_CAP_S = "3"
# a fleet answer against the one Predictor at bucket 1 (it may have run in
# another bucket: bf16 GEMMs of another M round otherwise), of max|logit|
FLEET_BF16_TOL = 5e-2
V2_LAYERS = 2                 # the process replica's LM: phase d's widths
V4_BUCKETS = (1, 8)
V5_SEQS, V5_STREAMS, V5_NEW = 8, 8, 48
V5_PROMPTS = (64, 200)
_V_FAILED = []


def v_check(ok, what):
    """Log a phase-v check; a failed one is collected and fails the phase
    at its end."""
    log(f"[v] {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        _V_FAILED.append(what)
    return ok


def fleet_lm(torch, mx, seed=0, layers=LAYERS):
    """Phase d's LM (GPT-2-small widths, bf16) with seeded weights."""
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    net = transformer.transformer_lm(
        vocab=VOCAB, units=UNITS, num_heads=HEADS, num_layers=layers,
        max_len=T, impl="flash", prefix="tlm_")
    net.initialize(mx.init.Xavier(), generator=torch.Generator(
        device="cuda").manual_seed(seed))
    net.cast("bfloat16")
    return net


def fleet_predictor(torch, mx, net, buckets=FLEET_BUCKETS):
    from mxnet_tpu_torch import serving

    return serving.Predictor.from_block(
        net, input_shapes={"data": (T,)}, batch_sizes=buckets,
        warmup=False).warmup(dtype="int64")


def fleet_child_predictor():
    """v2's factory, run in the spawned child: a V2_LAYERS-layer LM at
    phase d's widths, seed 0, bucket 1, on the card."""
    import torch

    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mx

    return fleet_predictor(torch, mx, fleet_lm(torch, mx, 0, V2_LAYERS),
                           buckets=(1,))


def _drive(torch, submit, requests, threads=FLEET_THREADS):
    """``requests[i]`` from thread i through ``submit``; returns (answers,
    errors, lost, wall s)."""
    answers = [[None] * len(r) for r in requests]
    errors, lost = [], []

    def client(i):
        futs = [submit(ids) for ids in requests[i]]
        for j, f in enumerate(futs):
            try:
                answers[i][j] = f.result(timeout=600)[0]
            except TimeoutError:
                lost.append((i, j))
            except Exception as e:   # noqa: BLE001 -- counted below
                errors.append(f"{type(e).__name__}: {str(e)[:80]}")

    ths = [threading.Thread(target=client, args=(i,))
           for i in range(threads)]
    t0 = time.perf_counter()
    for th in ths:
        th.start()
    for th in ths:
        th.join(900)
    if any(th.is_alive() for th in ths):
        lost.append("a client thread")
    return answers, errors, lost, time.perf_counter() - t0


def _pcts(xs):
    xs = sorted(xs)
    if not xs:
        return 0.0, 0.0
    return (xs[int(0.5 * (len(xs) - 1) + 0.5)],
            xs[int(0.99 * (len(xs) - 1) + 0.5)])


def _secs(x):
    return "not reached" if x is None else f"{x:.3f} s"


def _restart_walk(replica, since):
    """(the victim's walk after ``since``, seconds of its RESTARTING ->
    WARMING build (the capture), the fault-to-HEALTHY seconds)."""
    tr = [t for t in replica.transitions if t[0] >= since]
    walk = [(a, b) for _, a, b, _ in tr]
    build = [t1[0] - t0[0] for t0, t1 in zip(tr, tr[1:])
             if (t0[2], t1[2]) == ("RESTARTING", "WARMING")]
    healthy = [t[0] for t in tr if t[2] == "HEALTHY"]
    return walk, (build[-1] if build else None), \
        ((healthy[-1] - since) if healthy else None)


def fleet_drill(torch, serving, faults, fleet, kind, times, requests):
    """One drill on replica 0 under the 4 client threads (its siblings
    replay their graphs while it captures again): every future
    terminates, the victim walks the machine back to HEALTHY."""
    import gc

    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    victim = fleet.replicas()[0]
    before = serving.stats()
    t0 = time.monotonic()
    with faults.inject(kind, times=times) as f:
        answers, errors, lost, wall = _drive(
            torch, lambda ids: fleet.submit(ids, deadline_ms=FLEET_DEADLINE_MS),
            requests)
        deadline = time.monotonic() + 120
        while f.fired < times and time.monotonic() < deadline:
            fleet.submit(requests[0][0], deadline_ms=FLEET_DEADLINE_MS
                         ).result(timeout=600)
    deadline = time.monotonic() + 120
    while victim.generation < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    healthy = fleet.wait_healthy(timeout=120)
    walk, capture_s, failover_s = _restart_walk(victim, t0)
    after = serving.stats()
    delta = {k: after[k] - before[k] for k in (
        "fleet_retries", "fleet_replica_failures", "fleet_breaker_opens",
        "fleet_restarts", "fleet_shed_overloaded",
        "serving_stalled_batches")}
    machine = [("HEALTHY", "DRAINING"), ("DRAINING", "DEAD"),
               ("DEAD", "RESTARTING"), ("RESTARTING", "WARMING"),
               ("WARMING", "HEALTHY")]
    n = sum(len(r) for r in requests)
    done = sum(a is not None for r in answers for a in r)
    # the answers' logits (100 MB a request) are not the replicas' memory:
    # what is left after them is the abandoned replica's, if anything
    del answers
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    v_check(not lost and done + len(errors) == n and f.fired == times
            and healthy and walk[:5] == machine
            and victim.generation >= 2,
            f"v1 {kind} x{times} under {FLEET_THREADS} threads x "
            f"{len(requests[0])} requests: {done} answered, {len(errors)} "
            f"errors {errors[:2]}, {len(lost)} lost; victim walk "
            f"{walk}; counters {delta}; failover (fault to HEALTHY) "
            f"{_secs(failover_s)}, the restart's build and capture "
            f"{_secs(capture_s)}; device memory {mem0 / 2**20:.0f} -> "
            f"{mem1 / 2**20:.0f} MiB after the drill")
    return {"kind": kind, "answered": done, "errors": len(errors),
            "lost": len(lost), "walk": walk, "counters": delta,
            "failover_s": failover_s, "capture_s": capture_s,
            "wall_s": wall, "mem_before_mib": mem0 / 2**20,
            "mem_after_mib": mem1 / 2**20}


def fleet_v1(torch, mx, kernels, card):
    """v1: a Fleet of 2 thread replicas of phase d's LM (bf16, K1 on
    route "tc" at each bucket's warm-up runs and capture), 4 threads x 32
    requests at a deadline against one Predictor on the same weights, beside
    one BatchServer; then the replica_crash and replica_hang drills."""
    import numpy as np

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.resilience import faults

    zero_counts(kernels)
    t0 = time.perf_counter()
    # probes once a minute: a probe must not take a drill's one fire; one
    # failure opens a breaker (a crashed batch fails all its requests)
    fleet = serving.Fleet(
        lambda: fleet_predictor(torch, mx, fleet_lm(torch, mx)),
        replicas=2, probe_interval_ms=60000, breaker_k=1,
        breaker_cooldown_ms=1000, retries=2, backoff_ms=1,
        server_kw={"max_batch_size": 8, "batch_timeout_ms": 5.0})
    build_s = time.perf_counter() - t0
    ref = fleet_predictor(torch, mx, fleet_lm(torch, mx))
    rng = np.random.RandomState(7)
    requests = [[rng.randint(0, VOCAB, (1, T)).astype(np.int64)
                 for _ in range(FLEET_PER_THREAD)]
                for _ in range(FLEET_THREADS)]
    serving.reset_stats()
    answers, errors, lost, wall = _drive(
        torch, lambda ids: fleet.submit(ids, deadline_ms=FLEET_DEADLINE_MS),
        requests)
    st = serving.stats()
    n = FLEET_THREADS * FLEET_PER_THREAD
    worst, exact = 0.0, 0
    for i, row in enumerate(requests):
        for j, ids in enumerate(row):
            got = answers[i][j]
            if got is None:
                continue
            want = ref.predict(ids)[0]
            exact += bool(torch.equal(got, want))
            worst = max(worst, float((got.float() - want.float()).abs().max()
                                     / want.float().abs().max()))
    # 8 requests coalesced into one bucket-8 batch: bitwise equal to the
    # Predictor's bucket-8 predict of the same rows
    batch = [requests[0][j] for j in range(8)]
    slow = serving.Fleet(
        lambda: fleet_predictor(torch, mx, fleet_lm(torch, mx)),
        replicas=1, probe_interval_ms=60000,
        server_kw={"max_batch_size": 8, "batch_timeout_ms": 10000.0})
    try:
        futs = [slow.submit(ids) for ids in batch]
        coalesced = [f.result(timeout=600)[0] for f in futs]
    finally:
        slow.close()
    direct = ref.predict(np.concatenate(batch))[0]
    same8 = all(torch.equal(coalesced[j][0], direct[j]) for j in range(8))
    p50, p99 = st["fleet_p50_latency_us"] / 1e3, \
        st["fleet_p99_latency_us"] / 1e3
    v_check(not errors and not lost and worst <= FLEET_BF16_TOL and same8,
            f"v1 fleet of 2 replicas (built in {build_s:.2f} s), {n} "
            f"requests from {FLEET_THREADS} threads at deadline "
            f"{FLEET_DEADLINE_MS:g} ms: {n / wall:.2f} requests/s, p50 "
            f"{p50:.2f} ms, p99 {p99:.2f} ms ({card}); {exact} of {n} "
            f"answers bitwise the Predictor's bucket-1 predict, the rest "
            f"within {worst:.3e} of max|logit| (tol {FLEET_BF16_TOL:g}); "
            f"8 coalesced requests bitwise its bucket-8 predict: {same8}; "
            f"{len(errors)} errors, {len(lost)} lost")
    serving.reset_stats()
    with serving.BatchServer(ref, max_batch_size=8,
                             batch_timeout_ms=5.0) as server:
        _, b_err, b_lost, b_wall = _drive(torch, server.submit, requests)
    sb = serving.stats()
    b50, b99 = sb["serving_p50_latency_us"] / 1e3, \
        sb["serving_p99_latency_us"] / 1e3
    log(f"[v] v1 one BatchServer on one Predictor, the same requests: "
        f"{n / b_wall:.2f} requests/s, p50 {b50:.2f} ms, p99 {b99:.2f} ms "
        f"({card})")
    v_check(not b_err and not b_lost, "v1 the BatchServer answered all")

    drill_env = {"MXNET_TPU_TORCH_WATCHDOG_BATCH_TIMEOUT": FLEET_WATCHDOG_S,
                 "MXNET_TPU_TORCH_WATCHDOG_PROBE_TIMEOUT": "5",
                 "MXNET_TPU_TORCH_FAULT_HANG_CAP": FLEET_HANG_CAP_S}
    os.environ.update(drill_env)
    try:
        drills = [fleet_drill(torch, serving, faults, fleet, kind, 1,
                              [r[:8] for r in requests])
                  for kind in ("replica_crash", "replica_hang")]
    finally:
        for key in drill_env:
            os.environ.pop(key, None)
    by_route = dict(kernels.flash_attention.launches_by_route)
    builds = 2 + 1 + 1 + sum(d["counters"]["fleet_restarts"]
                             for d in drills)
    want = LAYERS * 3 * len(FLEET_BUCKETS) * builds
    v_check(by_route == {"tc": want, "tf32x3": 0, "simt": 0},
            f"v1 K1 launches {by_route} (want {want} on tc: "
            f"{LAYERS} at each bucket's 2 warm-up runs and capture, over "
            f"{builds} predictor builds -- the 2 replicas, the reference, "
            "the bucket-8 check's, and each restart -- none at a replay)")
    return fleet, ref, requests, {
        "build_s": build_s, "requests": n, "requests_per_s": n / wall,
        "p50_ms": p50, "p99_ms": p99, "bitwise": exact,
        "max_rel_err": worst, "coalesced_bitwise": same8,
        "batchserver": {"requests_per_s": n / b_wall, "p50_ms": b50,
                        "p99_ms": b99},
        "drills": drills, "k1_launches_by_route": by_route, "card": card}


def fleet_v2(torch, mx, card):
    """v2: one mode='process' replica built on the card in a spawned
    child; its answers bitwise a parent-side Predictor's on the same
    weights; SIGKILLed, restarted (a new pid), answering again."""
    import signal

    import numpy as np

    from mxnet_tpu_torch import serving

    rng = np.random.RandomState(3)
    ids = rng.randint(0, VOCAB, (1, T)).astype(np.int64)
    ref = fleet_predictor(torch, mx, fleet_lm(torch, mx, 0, V2_LAYERS),
                          buckets=(1,))
    want = ref.predict(ids)[0].cpu()
    t0 = time.perf_counter()
    fleet = serving.Fleet(fleet_child_predictor, replicas=1, mode="process",
                          probe_interval_ms=200, retries=0)
    try:
        start_s = time.perf_counter() - t0
        got = fleet.submit(ids, deadline_ms=FLEET_DEADLINE_MS).result(600)[0]
        r = fleet.replicas()[0]
        pid = r.pid
        t1 = time.monotonic()
        os.kill(pid, signal.SIGKILL)
        try:
            fleet.submit(ids, deadline_ms=FLEET_DEADLINE_MS).result(600)
            after_kill = "answered"
        except Exception as e:   # noqa: BLE001 -- a structured error
            after_kill = type(e).__name__
        deadline = time.monotonic() + 300
        while r.generation < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        healthy = fleet.wait_healthy(timeout=300)
        walk, build_s, restart_s = _restart_walk(r, t1)
        new_pid = r.pid
        again = fleet.submit(ids, deadline_ms=FLEET_DEADLINE_MS).result(
            600)[0]
    finally:
        fleet.close()
    v_check(torch.equal(got, want) and torch.equal(again, want) and healthy
            and new_pid not in (None, pid) and after_kill in (
                "ServerClosed", "FleetOverloaded", "answered"),
            f"v2 process replica ({V2_LAYERS}-layer LM, bf16) started in "
            f"{start_s:.2f} s; answers bitwise the parent's Predictor: "
            f"{torch.equal(got, want)}; SIGKILL of pid {pid}: the in-flight "
            f"request -> {after_kill}; restarted as pid {new_pid} in "
            f"{_secs(restart_s)} (kill to HEALTHY; the child's spawn, CUDA "
            f"start and capture {_secs(build_s)}), walk {walk}; answers "
            f"again bitwise: {torch.equal(again, want)} ({card})")
    return {"start_s": start_s, "restart_s": restart_s,
            "build_s": build_s, "after_kill": after_kill, "walk": walk}


def fleet_v3(torch, mx, fleet, ref, requests, card):
    """v3: swap_params into a Predictor's captured buckets (its replayed
    graph bitwise a fresh Predictor on the new weights, the snapshot
    restoring the old bitwise), then rollout_weights on v1's fleet: the
    poisoned candidate rolled back, then a good one promoted, with clients
    sending all along and none failing."""
    import numpy as np

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.resilience import faults

    new_net = fleet_lm(torch, mx, seed=1)
    fresh = fleet_predictor(torch, mx, new_net)
    ids8 = np.concatenate([r[0] for r in requests] * 2)
    before = ref.predict(ids8)[0]
    cand = {k: v.detach().clone()
            for k, v in new_net.collect_params().items()}
    replays = ref._exec.compiled_signatures
    t0 = time.perf_counter()
    prev = ref.swap_params(cand)
    swap_s = time.perf_counter() - t0
    after = ref.predict(ids8)[0]
    want = fresh.predict(ids8)[0]
    ref.swap_params(prev)
    back = ref.predict(ids8)[0]
    v_check(torch.equal(after, want) and not torch.equal(after, before)
            and torch.equal(back, before)
            and ref._exec.compiled_signatures == replays,
            f"v3 swap_params of {len(cand)} tensors into the captured "
            f"buckets in {swap_s * 1e3:.1f} ms: the bucket-8 graph's "
            f"replay bitwise a fresh Predictor on the new weights: "
            f"{torch.equal(after, want)}; the snapshot restores the old "
            f"bitwise: {torch.equal(back, before)}; no new capture")
    rm = serving.RolloutManager(fleet, eval_batch=ids8, canary_calls=4,
                                max_latency_x=50.0)
    # while the poisoned candidate sits on the canary, clients routed there
    # fail the sentinel and are retried on the other replica; a breaker that
    # opened on them would rebuild the canary from the factory's weights
    # mid-rollout, so it may not open here
    for r in fleet.replicas():
        r.breaker.k = 1000
    results = {"ok": 0, "err": 0}
    stop = threading.Event()

    def client():
        k = 0
        while not stop.is_set():
            try:
                fleet.submit(requests[1][k % 8], deadline_ms=FLEET_DEADLINE_MS
                             ).result(timeout=600)
                results["ok"] += 1
            except Exception:   # noqa: BLE001 -- counted
                results["err"] += 1
            k += 1

    th = threading.Thread(target=client)
    th.start()
    try:
        with faults.inject("rollout_bad_weights") as f:
            bad = rm.rollout_weights(cand)
        good = rm.rollout_weights(cand, reference=[want])
    finally:
        stop.set()
        th.join(600)
    served = [torch.equal(r.predictor.predict(ids8)[0], want)
              for r in fleet.replicas()]
    v_check(f.fired == 1 and bad["action"] == "rollback"
            and bad["gate"] == "health" and good["action"] == "promote"
            and results["err"] == 0 and results["ok"] > 0 and all(served),
            f"v3 rollout_weights: rollout_bad_weights -> {bad['action']} "
            f"at gate {bad.get('gate')}; the good weights -> "
            f"{good['action']} (agreement {good.get('agreement')}, canary "
            f"p50 {good.get('canary_p50_us')} us vs baseline "
            f"{good.get('baseline_p50_us')} us, {card}); every replica "
            f"serves the new weights bitwise: {served}; clients "
            f"{results['ok']} answered, {results['err']} errors")
    return {"swap_ms": swap_s * 1e3, "bad": bad, "good": good,
            "clients": dict(results)}


def fleet_v4(torch, mx, q, card):
    """v4: a {fp32, int8} variant group of phase p's ResNet-18 (2 replicas
    each), both variants served side by side (each answer bitwise its own
    Predictor's at bucket 8), then replica_nan_storm on an int8 replica:
    the sentinel fails its batches on their dequantized outputs, the
    router retries them on the other int8 replica, the victim restarts."""
    import shutil

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.resilience import faults

    os.makedirs(INT8_DIR, exist_ok=True)
    net = vision.resnet18_v1(classes=1000)
    net.initialize(mx.init.Xavier(),
                   generator=torch.Generator(device="cuda").manual_seed(0))
    sym_file, params_file = net.export(os.path.join(INT8_DIR, "resnet18_v1"))
    tail = {"data": (3, 224, 224)}
    k5_zero_counts(q)
    try:
        with k5_plain_guard(q):
            table = serving.Predictor(
                sym_file, params_file, input_shapes=tail,
                batch_sizes=(V4_BUCKETS[0],), quantize="int8",
                calib_data=mx.io.NDArrayIter(int8_images(INT8_CALIB, 1),
                                             batch_size=16),
                calib_mode="naive").calibration_table

            def make(quant):
                return serving.Predictor(
                    sym_file, params_file, input_shapes=tail,
                    batch_sizes=V4_BUCKETS, quantize=quant,
                    calib_table=table if quant else None)

            x = int8_images(16, 3)
            want = {v: [make(qt).predict(x[i:i + 8])[0] for i in (0, 8)]
                    for v, qt in (("fp32", None), ("int8", "int8"))}
            t0 = time.perf_counter()
            fleet = serving.Fleet(
                {"r18": {"fp32": lambda: make(None),
                         "int8": lambda: make("int8")}},
                replicas=2, probe_interval_ms=60000, breaker_k=2,
                breaker_cooldown_ms=1000, retries=2, backoff_ms=1,
                server_kw={"max_batch_size": 8, "batch_timeout_ms": 2.0})
            build_s = time.perf_counter() - t0
            try:
                reqs = {v: [x[i:i + 8] for i in (0, 8)] * 8
                        for v in ("fp32", "int8")}
                serving.reset_stats()
                out = {}
                t0 = time.perf_counter()
                for v in ("fp32", "int8"):
                    out[v] = [fleet.submit(b, model="r18", variant=v,
                                           deadline_ms=FLEET_DEADLINE_MS)
                              for b in reqs[v]]
                out = {v: [f.result(timeout=600)[0] for f in fs]
                       for v, fs in out.items()}
                wall = time.perf_counter() - t0
                same = all(torch.equal(o, want[v][k % 2])
                           for v in out for k, o in enumerate(out[v]))
                st = serving.stats()
                victim = fleet.replicas("r18", "int8")[0]
                os.environ["MXNET_TPU_TORCH_FAULT_REPLICA"] = str(victim.rid)
                t1 = time.monotonic()
                with faults.inject("replica_nan_storm", times=2) as f:
                    storm = [fleet.submit(x[0:8], model="r18",
                                          variant="int8",
                                          deadline_ms=FLEET_DEADLINE_MS)
                             for _ in range(8)]
                    storm = [s.result(timeout=600)[0] for s in storm]
                deadline = time.monotonic() + 120
                while victim.generation < 2 and time.monotonic() < deadline:
                    time.sleep(0.02)
                healthy = fleet.wait_healthy(timeout=120)
                walk, capture_s, failover_s = _restart_walk(victim, t1)
                sd = serving.stats()
            finally:
                fleet.close()
                os.environ.pop("MXNET_TPU_TORCH_FAULT_REPLICA", None)
    finally:
        shutil.rmtree(INT8_DIR, ignore_errors=True)
    counts = k5_counts(q)
    n = sum(len(v) for v in reqs.values())
    v_check(same and all(torch.equal(s, want["int8"][0]) for s in storm)
            and f.fired == 2 and healthy
            and sd["serving_poisoned_batches"] >= 2
            and walk[:5] == [("HEALTHY", "DRAINING"), ("DRAINING", "DEAD"),
                             ("DEAD", "RESTARTING"), ("RESTARTING",
                                                      "WARMING"),
                             ("WARMING", "HEALTHY")],
            f"v4 variant group {{fp32, int8}} of resnet18_v1 (2 replicas "
            f"each, built in {build_s:.2f} s): {n} 8-image requests in "
            f"{wall:.3f} s ({n * 8 / wall:.1f} images/s, p50 "
            f"{st['fleet_p50_latency_us'] / 1e3:.2f} ms, {card}), each "
            f"bitwise its variant's Predictor: {same}; replica_nan_storm x2 "
            f"on int8 replica {victim.rid}: {sd['serving_poisoned_batches']}"
            f" batches failed by the sentinel, every request answered "
            f"bitwise by the other int8 replica, victim walk {walk}, "
            f"failover {_secs(failover_s)}, rebuild and capture "
            f"{_secs(capture_s)}")
    v_check(counts["s8_conv"] > 0 and counts["s8_conv_requant"] > 0
            and counts["s8_matmul"] > 0 and counts["requant_int8"] > 0
            and counts["conv_by_route"]["mma_s8"] == 0
            and counts["matmul_by_route"]["mma_s8"] == 0,
            f"v4 K5 launches {counts} (the int8 predictors' builds and the "
            "restart; every conv and the FC on wgmma, none plain)")
    return {"build_s": build_s, "images_per_s": n * 8 / wall,
            "p50_ms": st["fleet_p50_latency_us"] / 1e3,
            "failover_s": failover_s, "capture_s": capture_s,
            "walk": walk, "k5_launches": counts}


def fleet_v5(torch, mx, kernels, card):
    """v5: a StreamRouter of 2 DecodeBatchers over phase n's model (bf16,
    fp32 KV, K4), V5_STREAMS streams of V5_NEW tokens, run unfaulted, then
    with decode_replica_death mid-stream: every stream completes, the dead
    engine's streams resume on the survivor (its pages all freed), the
    first divergence from the unfaulted tokens reported (bf16: a
    re-prefill of the streamed tokens may round otherwise than the steps
    that produced them), and the rerouted streams' gap at the reroute."""
    import numpy as np

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.ops import decode_attention as da
    from mxnet_tpu_torch.resilience import faults

    net = decode_net(torch, mx, "bfloat16")
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, VOCAB, rng.randint(*V5_PROMPTS)).tolist()
               for _ in range(V5_STREAMS)]

    def make():
        return serving.DecodePredictor(
            net, page_size=DECODE_PS, num_pages=V5_SEQS * DECODE_MAX_PAGES
            + 1, max_seqs=V5_SEQS, prefill_buckets=DECODE_BUCKETS,
            kv_dtype="float32")

    def run(router, rerouted):
        stamps = [[] for _ in prompts]
        streams = [router.submit_stream(p, V5_NEW) for p in prompts]

        def consume(i):
            for _ in streams[i].tokens(timeout=600):
                stamps[i].append(time.perf_counter())

        ths = [threading.Thread(target=consume, args=(i,))
               for i in range(len(streams))]
        for th in ths:
            th.start()
        for th in ths:
            th.join(600)
        toks = [s.generated for s in streams]
        gaps = [max(np.diff(s)) if len(s) > 1 else 0.0 for s in stamps]
        itl = [float(np.median(np.diff(s))) for s in stamps if len(s) > 1]
        blips = [gaps[i] for i, s in enumerate(streams)
                 if id(s) in rerouted]
        return toks, [s.ttft_s for s in streams], blips, \
            float(np.median(itl)), [s.reason for s in streams]

    zero_counts(kernels)
    t0 = time.perf_counter()
    router = serving.StreamRouter(make, replicas=2)
    build_s = time.perf_counter() - t0
    rerouted = set()
    for b in router.replicas:
        sink = b.death_sink
        b.death_sink = (lambda items, exc, sink=sink:
                        (rerouted.update(id(s) for s, *_ in items),
                         sink(items, exc))[1])
    try:
        base, ttft0, _, itl0, _ = run(router, set())
        serving.reset_stats()
        with faults.inject("decode_replica_death", at_step=V5_NEW // 2) as f:
            got, ttft1, blips, itl1, reasons = run(router, rerouted)
        st = serving.stats()
        pools = [b.predictor.pool.in_use for b in router.replicas]
        live = router.live_replicas
        rebuilt = router.revive()
    finally:
        router.close()
    launches = dict(da.paged_decode_attention.launches_by_route)
    diverge = [next((k for k, (a, b) in enumerate(zip(x, y)) if a != b),
                    None) for x, y in zip(got, base)]
    complete = all(len(t) == V5_NEW for t in got) and all(
        r == "length" for r in reasons)
    v_check(f.fired == 1 and complete and st["decode_reroutes"] >= 1
            and len(rerouted) == st["decode_reroutes"] and live == 1
            and rebuilt == 1 and pools == [0, 0],
            f"v5 StreamRouter of 2 DecodeBatchers (bf16 GPT-2-small, fp32 "
            f"KV, built in {build_s:.2f} s): {V5_STREAMS} streams x "
            f"{V5_NEW} tokens; decode_replica_death mid-stream: "
            f"decode_reroutes {st['decode_reroutes']}, every stream "
            f"completed: {complete}; pages in use after {pools}; the "
            f"rerouted streams' largest token gap "
            f"{[round(float(b) * 1e3, 2) for b in blips]} ms against a "
            f"median "
            f"inter-token {itl1 * 1e3:.2f} ms (unfaulted {itl0 * 1e3:.2f} "
            f"ms), TTFT p50 {np.median(ttft1) * 1e3:.2f} ms; first "
            f"divergence from the unfaulted tokens per stream {diverge} "
            f"(bf16; None: equal) ({card})")
    want = {"float32": 3 * LAYERS * 3, "int8": 0, "int8_bulk": 0}
    v_check(launches == want,
            f"v5 K4 launches {launches} (want {want['float32']} on float32: "
            f"the step's 2 warm-up runs and capture in each of 3 predictor "
            "builds -- the 2 replicas and the revived one)")
    return {"build_s": build_s, "reroutes": st["decode_reroutes"],
            "blip_ms": [float(b) * 1e3 for b in blips],
            "itl_ms": itl1 * 1e3,
            "unfaulted_itl_ms": itl0 * 1e3, "divergence": diverge,
            "k4_launches_by_route": launches}


def fleet_phase(torch, mx, kernels, q):
    """Phase v: v1-v5; checks collected, the phase fails at its end."""
    _V_FAILED.clear()
    card = card_identity()
    t0 = time.perf_counter()
    fleet, ref, requests, v1 = fleet_v1(torch, mx, kernels, card)
    try:
        v3 = fleet_v3(torch, mx, fleet, ref, requests, card)
    finally:
        fleet.close()
    del fleet, ref
    torch.cuda.empty_cache()
    v2 = fleet_v2(torch, mx, card)
    v4 = fleet_v4(torch, mx, q, card)
    v5 = fleet_v5(torch, mx, kernels, card)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"[v] phase v took {wall:.1f} s ({card})")
    if _V_FAILED:
        raise SystemExit("phase v: " + "; ".join(_V_FAILED))
    return {"v1": v1, "v2": v2, "v3": v3, "v4": v4, "v5": v5,
            "wall_s": wall, "card": card}


def check_fold(torch):
    """Phase b for the fold kernel (csrc/state_fold.cu): on fixed leaves of
    every dtype it takes (fp32, bf16, fp16, int32, int8, uint8, bool,
    empty, an unaligned view, several blocks' worth), alone and together,
    the kernel's 32-bit value equals its plain version's and fold_host's
    exactly (integer arithmetic: no tolerance), a second launch the
    same; an 8-byte leaf raises."""
    from mxnet_tpu_torch.resilience import integrity

    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def randint(lo, hi, n, dtype):
        return torch.randint(lo, hi, (n,), generator=gen, device="cuda",
                             dtype=dtype)

    base = randn(4097)
    leaves = {
        "f32_odd": randn(1001), "f32_2d": randn(257, 33),
        "f32_blocks": randn(3_000_001),
        "bf16": randn(4099).to(torch.bfloat16),
        "f16": randn(77).to(torch.float16),
        "i32": randint(-2 ** 31, 2 ** 31 - 1, 999, torch.int32),
        "i8": randint(-128, 128, 333, torch.int8),
        "u8": randint(0, 256, 4097, torch.uint8),
        "bool": randn(999) > 0, "empty": randn(0, 5),
        "unaligned": base[1:]}
    cases = [{k: v} for k, v in leaves.items()] + [leaves]
    out = []
    for named in cases:
        got = integrity.as_uint32(integrity.fold_tree(named))
        again = integrity.as_uint32(integrity.fold_tree(named))
        plain = integrity.as_uint32(integrity.fold_plain(named))
        host = integrity.fold_host({k: v.cpu() for k, v in named.items()})
        name = "+".join(named) if len(named) < 3 else "all"
        ok = got == again == plain == host
        log(f"[b] state_fold {name}: kernel {got:#010x}, plain {plain:#010x}"
            f", fold_host {host:#010x} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase b: state_fold disagrees on {name}")
        out.append({"case": name, "max_abs_err": abs(got - plain)})
    # the split for several ranks: state_fold_sums (a leaf left out sums
    # to 0) and state_fold_chain, exactly their plain versions, and the
    # chain of every leaf's sums state_fold's value
    names = sorted(leaves)
    counted = {k: i % 2 == 0 for i, k in enumerate(names)}
    for flags, label in ((None, "all counted"), (counted, "every other")):
        sums = integrity.fold_sums(leaves, flags)
        plain = integrity.sums_plain(leaves, flags)
        chain = integrity.as_uint32(integrity.fold_chain(sums, names))
        chain_plain = integrity.as_uint32(integrity.chain_plain(
            plain, [integrity._crc(n) for n in names]))
        ok = torch.equal(sums, plain) and chain == chain_plain
        if flags is None:
            ok = ok and chain == integrity.as_uint32(
                integrity.fold_tree(leaves))
        log(f"[b] state_fold_sums + state_fold_chain ({label}): chain "
            f"{chain:#010x}, plain {chain_plain:#010x} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase b: state_fold_sums / _chain disagree "
                             f"({label})")
        out.append({"case": f"sums+chain {label}",
                    "max_abs_err": int((sums - plain).abs().max())})
    try:
        integrity.fold_tree({"f64": randn(8).double()})
        raise SystemExit("phase b: state_fold took an 8-byte leaf")
    except TypeError:
        log("[b] state_fold: an 8-byte leaf raises TypeError ok")
    # a graph over leaves that keep their warm-up addresses (static
    # gradients) reads the eager table warm-up made: more eager layouts
    # than the eager cap must not evict it before the graph replays
    from mxnet_tpu_torch import capture

    static = {"w": randn(70_001), "g": randn(5003).to(torch.bfloat16)}
    fold = capture.CapturedExec(lambda: integrity.fold_tree(static),
                                label="fold_static", device="cuda")
    before = integrity.as_uint32(fold())
    for i in range(integrity._TABLES_EAGER_CAP + 1):
        integrity.fold_tree({f"x{i}": randn(1000 + 100 * i)})
    with torch.no_grad():
        static["w"].mul_(1.5)
        static["g"].add_(1)
    got = integrity.as_uint32(fold())
    plain = integrity.as_uint32(integrity.fold_plain(static))
    ok = got == plain != before
    log(f"[b] state_fold captured over static leaves, replayed after "
        f"{integrity._TABLES_EAGER_CAP + 1} other eager layouts: "
        f"{got:#010x}, plain {plain:#010x} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase b: state_fold's captured table was lost")
    out.append({"case": "captured static", "max_abs_err": abs(got - plain)})
    return out


# ------------------------------------------------------------------ phase w
# Resilient training: the LM of phases h / l (GPT-2-small widths, bf16
# compute over fp32 masters, Adam lr 1e-3, B=8, T=1024) through
# parallel.ShardedTrainer, with checkpoints, the elastic OOM retry, the
# integrity fold, the numerics tap, the perf ledger and the profiler.
W_DIR = os.path.join(ROOT, "_resilience")   # gitignored: checkpoints
W_STEPS = 20            # the child's steps before the kill
W_RESUME_TO = 25        # the resumed run's last step
W_SAVE_EVERY = 5
W_AUDIT_EVERY = 2
W_TAP_EVERY = 5
W_TAP_TOL = 1e-5        # tap stats vs eager reductions, of max(|ref|, 1)
W_TAP_GRAD_TOL = 1e-3   # grad rows: recomputed eagerly, bf16 GEMMs may
                        # round otherwise outside the graph
W_HANG_S = 2.0          # the gluon step's watchdog deadline in w5
_W_FAILED = []


def w_check(ok, what):
    log(f"[w] {what}: {'ok' if ok else 'FAIL'}")
    if not ok:
        _W_FAILED.append(what)


def w_batch(torch, step):
    """Step ``step``'s batch: the learnable sequence from seed ``step``."""
    return lm_batch(torch, BATCH, T, VOCAB, seed=1000 + step)


def w_net(torch, mx, seed=0):
    """Phase h's LM at full width, fp32 (the trainer's masters), seeded
    Xavier weights."""
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    net = transformer.transformer_lm(
        vocab=VOCAB, units=UNITS, num_heads=HEADS, num_layers=LAYERS,
        max_len=T, impl="flash", prefix="tlm_")
    net.initialize(mx.init.Xavier(), generator=torch.Generator(
        device="cuda").manual_seed(seed))
    return net


def w_trainer(mx, net, **kw):
    return mx.parallel.ShardedTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": LR}, dtype="bfloat16", **kw)


def w_same(torch, a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def resilience_child(out_dir):
    """w1's child: 20 steps from the seeded LM, an async save every 5 steps
    (keep_n=2), one JSON line a step; after the step-20 save is launched
    it writes the marker ``save20`` and waits to be killed."""
    import torch

    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.resilience import CheckpointManager

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT"] = "1"
    tr = w_trainer(mx, w_net(torch, mx))
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"), keep_n=2)
    with open(os.path.join(out_dir, "child.jsonl"), "w") as f:
        for s in range(1, W_STEPS + 1):
            x, y = w_batch(torch, s)
            loss = tr.step(x, y)
            rec = {"step": s, "loss": loss.item(), "fp": tr.last_fingerprint}
            if s % W_SAVE_EVERY == 0:
                mgr.save(s, trainer=tr, async_=True)
                rec["save"] = mgr.last_save
            f.write(json.dumps(rec) + "\n")
            f.flush()
    with open(os.path.join(out_dir, "save20"), "w") as f:
        f.write(str(os.getpid()))
    time.sleep(600)
    return 1


def w1_kill_and_resume(torch, mx, net):
    """A spawned child trains 20 steps, saving async every 5, and is
    SIGKILLed while its step-20 save is in flight; restore_latest must
    skip the torn save and take step 15, and steps 16-25 from it must be
    bitwise an unkilled run's (losses and step fingerprints)."""
    import shutil
    import signal as _signal

    from mxnet_tpu_torch.resilience import CheckpointManager, checkpoint

    shutil.rmtree(W_DIR, ignore_errors=True)
    os.makedirs(W_DIR)
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--resilience-child", W_DIR])
    ref, ref_ms = {}, []
    try:
        r = w_trainer(mx, net)
        for s in range(1, W_RESUME_TO + 1):
            x, y = w_batch(torch, s)
            t0 = time.perf_counter()
            loss = r.step(x, y)
            ref[s] = (loss.item(), r.last_fingerprint)
            ref_ms.append((time.perf_counter() - t0) * 1e3)
        del r
        marker = os.path.join(W_DIR, "save20")
        deadline = time.monotonic() + 300
        while not os.path.exists(marker):
            if child.poll() is not None:
                raise SystemExit(f"phase w1: the child exited "
                                 f"({child.returncode}) before its step-20 "
                                 "save")
            if time.monotonic() > deadline:
                raise SystemExit("phase w1: no step-20 save within 300 s")
            time.sleep(0.002)
        os.kill(child.pid, _signal.SIGKILL)
        child.wait(60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(60)
    with open(os.path.join(W_DIR, "child.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    debris = [n for n in os.listdir(os.path.join(W_DIR, "ckpt"))
              if ".tmp." in n]
    mgr = CheckpointManager(os.path.join(W_DIR, "ckpt"), keep_n=2)
    listed = [s for s, _ in mgr.list_checkpoints()]
    tr = w_trainer(mx, net)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    manifest = mgr.restore_latest(trainer=tr)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    w_check(manifest is not None and manifest["step"] == 15
            and 20 not in listed,
            f"w1 restore_latest took step "
            f"{None if manifest is None else manifest['step']} (published "
            f"{listed}; the torn step-20 save left {len(debris)} temp dir(s)"
            ", removed by the next manager)")
    w_check(all(recs[s - 1]["loss"] == ref[s][0]
                and recs[s - 1]["fp"] == ref[s][1] for s in range(1, 21)),
            "w1 the child's steps 1-20 bitwise the unkilled run's (losses "
            "and fingerprints)")
    kernels_zero()
    got = {}
    for s in range(16, W_RESUME_TO + 1):
        x, y = w_batch(torch, s)
        loss = tr.step(x, y)
        got[s] = (loss.item(), tr.last_fingerprint)
    main_path = kernel_counts()
    same = all(got[s] == ref[s] for s in got)
    w_check(same, "w1 resumed steps 16-25 bitwise the unkilled run's "
            f"(losses {got[16][0]:.6f} .. {got[25][0]:.6f}, fingerprints "
            f"{got[16][1]:#010x} .. {got[25][1]:#010x})")
    steady = sorted(ref_ms[1:])[len(ref_ms[1:]) // 2]
    x, y = w_batch(torch, W_RESUME_TO)
    torch.cuda.synchronize()
    mgr.save(W_RESUME_TO + 1, trainer=tr)
    sync = dict(mgr.last_save)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(W_RESUME_TO + 2, trainer=tr, async_=True)
    stall_async = time.perf_counter() - t0
    tr.step(x, y)
    torch.cuda.synchronize()
    next_ms = (time.perf_counter() - t0) * 1e3
    mgr.wait_for_async()
    publish_s = time.perf_counter() - t0
    child_stalls = [r["save"]["stall_s"] for r in recs if "save" in r]
    out = {"restored_step": manifest["step"], "listed": listed,
           "debris": len(debris), "restore_s": restore_s,
           "save_bytes": sync["bytes"], "sync_save_s": sync["stall_s"],
           "async_stall_s": stall_async,
           "async_save_plus_step_ms": next_ms,
           "async_publish_s": publish_s, "child_async_stall_s":
           child_stalls, "median_step_ms": steady,
           "main_path": main_path, "resumed_bitwise": same}
    log(f"[w1] {sync['bytes'] / 2**30:.2f} GiB a checkpoint: sync save "
        f"{sync['stall_s']:.3f} s of stall; async save "
        f"{stall_async * 1e3:.1f} ms of stall (the child's "
        f"{', '.join(f'{s * 1e3:.1f}' for s in child_stalls)} ms), the next "
        f"step {next_ms:.1f} ms with it (median step {steady:.2f} ms), "
        f"published {publish_s:.3f} s after the call; restore "
        f"{restore_s:.3f} s; main-path launches {main_path}")
    del tr
    shutil.rmtree(W_DIR, ignore_errors=True)
    return out


def kernels_zero():
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.resilience import integrity

    zero_counts(kernels)
    integrity.fold_tree.launches = 0


def kernel_counts():
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.resilience import integrity

    return {"k1": dict(kernels.flash_attention.launches_by_route),
            "k2": dict(kernels.flash_attention_backward.launches_by_route),
            "fold": integrity.fold_tree.launches}


def w2_elastic(torch, mx, net):
    """B=8 under a memory cap that a B=8 step exceeds and two B=4
    microbatches fit: a real torch.OutOfMemoryError, retried as 2
    microbatches, sticky, bitwise an explicit microbatches=2 step; then
    the oom_step fault without the cap, the same."""
    import gc
    import warnings

    from mxnet_tpu_torch.resilience import elastic, faults

    x, y = w_batch(torch, 1)
    gc.collect()
    torch.cuda.empty_cache()
    ref = w_trainer(mx, net)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    l_ref = ref.step(x, y, microbatches=2)
    peak_mb2 = torch.cuda.max_memory_allocated() - base
    ref_params = {k: v.detach().clone() for k, v in ref.params.items()}
    l_ref2 = ref.step(x, y, microbatches=2)
    ref_params2 = {k: v.detach().clone() for k, v in ref.params.items()}
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    tr = w_trainer(mx, net)
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    cap = torch.cuda.memory_reserved() + int(peak_mb2 * 1.15) + (256 << 20)
    elastic.reset_stats()
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loss = tr.step(x, y)
        real_oom = any("OOM" in str(w.message) for w in caught)
        st = elastic.stats()
        ok = real_oom and st["elastic_oom_events"] == 1 and \
            tr._elastic_n == 2 and loss.item() == l_ref.item() and \
            w_same(torch, tr.params, ref_params)
        w_check(ok, f"w2 under a {cap / 2**30:.2f} GiB cap (B=4 x 2 peaked "
                f"{peak_mb2 / 2**30:.2f} GiB over the trainer): a real "
                f"torch.OutOfMemoryError retried as {tr._elastic_n} "
                f"microbatches, bitwise microbatches=2 ({st})")
        loss = tr.step(x, y)
        st2 = elastic.stats()
        w_check(st2["elastic_oom_events"] == 1 and tr._elastic_n == 2
                and loss.item() == l_ref2.item()
                and w_same(torch, tr.params, ref_params2),
                "w2 the next step stays at 2 microbatches (sticky), no new "
                "OOM, bitwise")
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    tr = w_trainer(mx, net)
    elastic.reset_stats()
    with faults.inject("oom_step", times=1) as f, \
            warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        loss = tr.step(x, y)
    w_check(f.fired == 1 and tr._elastic_n == 2
            and loss.item() == l_ref.item()
            and w_same(torch, tr.params, ref_params),
            "w2 oom_step (no cap): retried as 2 microbatches, bitwise "
            "microbatches=2")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return {"cap_bytes": cap, "peak_mb2_bytes": peak_mb2}


def w3_integrity(torch, mx, net):
    """The fold kernel over the LM's whole state (fp32 masters and their
    gradients) against its plain version and fold_host, timed beside its
    bound; the audit catching sdc_bitflip_param; the step with and
    without the fingerprint."""
    import gc

    from mxnet_tpu_torch.resilience import faults, integrity

    tr = w_trainer(mx, net)
    x, y = w_batch(torch, 1)
    tr.step(x, y)
    _, grads = tr._loss_and_mean_grads(x, y, 1)
    named = {f"param:{k}": v for k, v in tr.params.items()}
    named.update({f"grad:{k}": v.contiguous() for k, v in grads.items()})
    nbytes = sum(v.numel() * v.element_size() for v in named.values())
    got = integrity.as_uint32(integrity.fold_tree(named))
    plain = integrity.as_uint32(integrity.fold_plain(named))
    host = integrity.fold_host({k: v.cpu() for k, v in named.items()})
    w_check(got == plain == host, f"w3 fold kernel {got:#010x}, plain "
            f"{plain:#010x}, fold_host {host:#010x} over {len(named)} "
            f"leaves, {nbytes / 2**30:.2f} GiB")
    ms = device_ms(lambda: integrity.fold_tree(named), n=20)
    # the plain version's ~4,000 launches a call outrun the card's work
    # from the host even as one graph: timed as graph replays, which log
    # whether the host fell behind
    plain_ms = graph_ms(torch, lambda: integrity.fold_plain(named), "w3",
                        n=5)
    bound_ms = nbytes / PEAK_BYTES * 1e3
    log(f"[w3] state_fold: {ms:.4f} ms device ({nbytes / ms / 1e6:.0f} "
        f"GB/s, {bound_ms / ms:.1%} of the {bound_ms:.4f} ms bytes bound); "
        f"plain version {plain_ms:.3f} ms")
    del named, grads
    # the step with and without the fingerprint (one trainer, two graphs)
    times = {}
    for mode in ("0", "1", "0", "1"):
        os.environ["MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT"] = mode
        ms_ = []
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.step(x, y)
            torch.cuda.synchronize()
            ms_.append((time.perf_counter() - t0) * 1e3)
        times.setdefault(mode, []).extend(ms_[1:])
    os.environ["MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT"] = "1"
    med = {m: sorted(v)[len(v) // 2] for m, v in times.items()}
    log(f"[w3] step without the fingerprint {med['0']:.2f} ms, with it "
        f"{med['1']:.2f} ms (+{med['1'] - med['0']:.2f} ms, "
        f"{(med['1'] - med['0']) / med['0']:.1%}); host clock, median of "
        "14 in turns")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    # the audit: a bit flip after step 2's update, caught and rolled back
    os.environ["MXNET_TPU_TORCH_INTEGRITY_AUDIT_EVERY"] = str(W_AUDIT_EVERY)
    try:
        finals = []
        for faulted in (False, True):
            integrity.reset_stats()
            tr = w_trainer(mx, net)
            ctx = faults.inject("sdc_bitflip_param", at_step=1, times=1) \
                if faulted else contextlib.nullcontext()
            with ctx:
                for s in range(1, 5):
                    xs, ys = w_batch(torch, s)
                    tr.step(xs, ys)
            finals.append(({k: v.detach().clone()
                            for k, v in tr.params.items()},
                           tr.last_fingerprint, integrity.stats()))
            del tr
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        del os.environ["MXNET_TPU_TORCH_INTEGRITY_AUDIT_EVERY"]
    st = finals[1][2]
    w_check(st["integrity_audit_mismatches"] == 1
            and st["integrity_rollbacks"] == 1
            and st["integrity_selftest_failures"] == 0
            and finals[0][1] == finals[1][1]
            and w_same(torch, finals[0][0], finals[1][0]),
            f"w3 sdc_bitflip_param caught by the audit (every "
            f"{W_AUDIT_EVERY} steps), self-test passed, rolled back and run "
            "again: the final params bitwise the unfaulted run's "
            f"({ {k: v for k, v in st.items() if v} })")
    return {"fold_ms": ms, "fold_plain_ms": plain_ms,
            "fold_bound_ms": bound_ms, "fold_bytes": nbytes,
            "fold_err": abs(got - plain), "step_ms_no_fp": med["0"],
            "step_ms_fp": med["1"]}


def w4_observe(torch, mx, net):
    """The numerics tap on the captured step every 5 steps, its stats
    against eager reductions of the same tensors and no capture when the
    cadence changes; the perf ledger's FLOPs, device ms and MFU; the
    profiler's Chrome trace naming K1 and K2; traceview over the step's
    spans."""
    import gc

    from mxnet_tpu_torch import capture, profiler
    from mxnet_tpu_torch.observability import (numerics, perf, trace,
                                               traceview)

    def eager_row(v, den):
        # the five stat columns in plain torch, float64 sums: l2, max |v|,
        # NaN/Inf count, the share of nonzeros that fp16 flushes to 0,
        # and l2 over den's l2 (update rows)
        v64 = v.double()
        l2 = v64.square().sum().sqrt().item()
        nz = v != 0
        ratio = 0.0 if den is None else \
            l2 / (den.double().square().sum().sqrt().item() + 1e-12)
        return [l2, v.abs().max().item() if v.numel() else 0.0,
                float((~torch.isfinite(v)).sum().item()),
                (nz & (v.half() == 0)).sum().item()
                / max(nz.sum().item(), 1), ratio]

    numerics.reset()
    perf.clear()
    tap = numerics.NumericsTap(interval=W_TAP_EVERY, policy="record")
    tr = w_trainer(mx, net)
    tr.attach_numerics(tap)
    x, y = w_batch(torch, 1)
    for _ in range(W_TAP_EVERY):        # samples at the first step
        tr.step(x, y)
    pre = {k: v.detach().clone() for k, v in tr.params.items()}
    tr.step(x, y)                       # a sampled step
    sample = numerics.history()[-1]["tensors"]
    post = tr.params
    tr_params = tr.params
    saved = {k: v.detach().clone() for k, v in post.items()}
    with torch.no_grad():
        for k, v in pre.items():
            tr_params[k].copy_(v)
    _, grads = tr._loss_and_mean_grads(x, y, 1)
    with torch.no_grad():
        for k, v in saved.items():
            tr_params[k].copy_(v)
    worst = {"same": 0.0, "grad": 0.0}
    for k in sorted(pre):
        for name, v, den in ((f"grad:{k}", grads[k].float(), None),
                             (f"param:{k}", pre[k].float(), None),
                             (f"update:{k}", post[k].float() - pre[k].float(),
                              pre[k].float())):
            want = eager_row(v.reshape(-1), den)
            got_row = sample[name]
            kind = "grad" if name.startswith("grad:") else "same"
            for stat, w_ in zip(numerics.NUMERICS_STATS, want):
                worst[kind] = max(worst[kind], abs(got_row[stat] - w_)
                                  / max(abs(w_), 1.0))
    w_check(worst["same"] <= W_TAP_TOL and worst["grad"] <= W_TAP_GRAD_TOL,
            f"w4 the tap's {len(sample)} rows x 5 stats against eager torch "
            f"reductions, of max(|ref|, 1): param and update rows (the "
            f"same tensors) {worst['same']:.2e} (tol {W_TAP_TOL:g}), grad "
            f"rows (recomputed eagerly from the pre-step state) "
            f"{worst['grad']:.2e} (tol {W_TAP_GRAD_TOL:g})")
    misses = capture.stats()["capture_misses"]
    tap.set_interval(2)
    tap.set_stats(("l2", "maxabs"))
    for _ in range(4):
        tr.step(x, y)
    w_check(capture.stats()["capture_misses"] == misses,
            f"w4 cadence 5 -> 2 and stats -> (l2, maxabs): no capture "
            f"({misses} captures before and after); "
            f"{len(numerics.history())} samples")
    # perf: device time on, a few replays of the untapped graph
    tr.attach_numerics(None)
    perf.set_device_time(True)
    try:
        for _ in range(5):
            tr.step(x, y)
    finally:
        perf.set_device_time(False)
    timed = [e for e in perf.ledger().values() if e["device_calls"]]
    e = max(timed, key=lambda e: e["device_calls"]) if timed else None
    w_check(e is not None and bool(e["flops"]) and e["mfu"] is not None
            and 0 < e["mfu"] < 1,
            f"w4 perf ledger {len(perf.ledger())} graphs; the step's: "
            + ("no device-timed graph" if e is None else
               f"{e['flops'] / 1e12:.3f} TFLOP a step, device "
               f"{e['device_ms']:.2f} ms, MFU {(e['mfu'] or 0):.1%} of 989 "
               f"TFLOP/s, peak {e['peak_hbm_bytes'] / 2**30:.2f} GiB, "
               f"capture {e['compile_ms'] / 1e3:.2f} s"))
    e = e or {"flops": None, "device_ms": None, "mfu": None}
    peaks = {k: v["peak_hbm_bytes"] for k, v in perf.ledger().items()}
    log(f"[w4] graphs' peak memory (warm-up to capture): "
        + ", ".join(f"{k} {v / 2**30:.2f} GiB" for k, v in peaks.items()))
    # the profiler and traceview over one step
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out", "phase_w_profile.json")
    profiler.set_config(filename=path)
    trace.set_enabled(True)
    try:
        profiler.set_state("run")
        with profiler.scope("w4_step"):
            tr.step(x, y)
        profiler.set_state("stop")
        profiler.dump()
        spans = trace.spans()
    finally:
        trace.set_enabled(False)
    with open(path) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    has = {k: any(k in n for n in names)
           for k in ("flash_fwd_tc", "flash_bwd_dkdv_tc", "flash_bwd_dq_tc",
                     "fold_partials", "w4_step")}
    w_check(has["flash_fwd_tc"] and has["flash_bwd_dkdv_tc"]
            and has["fold_partials"],
            f"w4 profiler.dump(): {len(names)} event names; {has}")
    chrome = traceview.to_chrome_trace(spans)
    got_spans = {ev["name"] for ev in chrome["traceEvents"]
                 if ev.get("ph") == "X"}
    w_check("train.sharded_step" in got_spans
            and "sharded.execute" in got_spans,
            f"w4 traceview: {len(chrome['traceEvents'])} events, spans "
            f"{sorted(got_spans)}")
    log("[w4] profiler.dumps() head:\n" + "\n".join(
        profiler.dumps().splitlines()[:12]))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return {"tap_worst": worst, "flops": e["flops"],
            "device_ms": e["device_ms"], "mfu": e["mfu"],
            "graph_peaks": peaks, "profile_names": has}


def w5_gluon(torch, mx):
    """The gluon.Trainer path (phase h's bf16 LM, Adam): a rollback-policy
    HealthSentinel with a manager; nan_grad armed: the bad step skipped
    and rolled back; hang_step under a 2 s step deadline: the stall
    rolled back; an AMP fp16 trainer's loss scale through a checkpoint."""
    import gc
    import shutil

    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon.model_zoo import transformer
    from mxnet_tpu_torch.resilience import (CheckpointManager,
                                            HealthSentinel, faults,
                                            sentinel, watchdog)

    shutil.rmtree(W_DIR, ignore_errors=True)
    net = w_net(torch, mx)
    net.cast("bfloat16")
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": LR})
    mgr = CheckpointManager(os.path.join(W_DIR, "gluon"), keep_n=2)
    sent = HealthSentinel(policy="rollback").attach(
        trainer, net=net, checkpoint_manager=mgr)
    x, y = w_batch(torch, 1)

    def step():
        with mx.autograd.record():
            loss = ce(net(x), y).mean()
        loss.backward()
        trainer.step(1)
        return loss

    step()
    mgr.save(1, net=net, trainer=trainer)
    saved = {k: v.detach().clone() for k, v in net.collect_params().items()}
    sentinel.reset_stats()
    with faults.inject("nan_grad"):
        step()
    st = sentinel.stats()
    w_check(st["sentinel_nonfinite"] == 1 and st["sentinel_rollbacks"] == 1
            and st["health_skipped_steps"] == 1
            and w_same(torch, dict(net.collect_params()), saved),
            f"w5 nan_grad: the step skipped and rolled back to step 1 "
            f"({ {k: v for k, v in st.items() if v} })")
    os.environ["MXNET_TPU_TORCH_WATCHDOG_STEP_TIMEOUT"] = str(W_HANG_S)
    watchdog.reset_stats()
    try:
        t0 = time.perf_counter()
        with faults.inject("hang_step"):
            step()
        hang_s = time.perf_counter() - t0
    finally:
        del os.environ["MXNET_TPU_TORCH_WATCHDOG_STEP_TIMEOUT"]
    ws = watchdog.stats()
    w_check(ws["watchdog_stalls"] == 1 and ws["watchdog_rollbacks"] == 1
            and w_same(torch, dict(net.collect_params()), saved),
            f"w5 hang_step: the step returned after {hang_s:.2f} s (a "
            f"{W_HANG_S:g} s deadline, then the rollback's restore), rolled "
            f"back to step 1 ({ws})")
    sent.detach()
    loss = step()
    w_check(bool(torch.isfinite(loss)), "w5 training goes on after both")
    del net, trainer, saved
    gc.collect()
    torch.cuda.empty_cache()
    # AMP: the loss scaler's state through a checkpoint (a 2-layer LM)
    amp.init("float16")
    try:
        small = transformer.transformer_lm(
            vocab=VOCAB, units=UNITS, num_heads=HEADS, num_layers=2,
            max_len=T, impl="flash", prefix="tlm_")
        small.initialize(mx.init.Xavier(), generator=torch.Generator(
            device="cuda").manual_seed(0))
        tr16 = mx.gluon.Trainer(small.collect_params(), "adam",
                                {"learning_rate": LR})
        amp.init_trainer(tr16)
        with mx.autograd.record():
            loss = ce(small(x), y).mean()
        with amp.scale_loss(loss, tr16) as scaled:
            scaled.backward()
        if amp.unscale(tr16):
            tr16.step(1)
        scaler = tr16._amp_loss_scaler
        scaler.loss_scale, scaler._unskipped = 1024.0, 7
        mgr.save(2, net=small, trainer=tr16)
        scaler.loss_scale, scaler._unskipped = 3.0, 0
        m = mgr.restore_latest(net=small, trainer=tr16)
        w_check(m["step"] == 2 and scaler.loss_scale == 1024.0
                and scaler._unskipped == 7,
                f"w5 AMP fp16: the loss scale {scaler.loss_scale:g} "
                f"(unskipped {scaler._unskipped}) back from the checkpoint")
    finally:
        amp.reset()
    shutil.rmtree(W_DIR, ignore_errors=True)
    return {"hang_s": hang_s}


def resilience_phase(torch, mx):
    """Phase w: w1-w5 on one card."""
    t0 = time.perf_counter()
    os.environ["MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT"] = "1"
    try:
        net = w_net(torch, mx)
        out = {"w1": w1_kill_and_resume(torch, mx, net)}
        out["w2"] = w2_elastic(torch, mx, net)
        out["w3"] = w3_integrity(torch, mx, net)
        out["w4"] = w4_observe(torch, mx, net)
        del net
        out["w5"] = w5_gluon(torch, mx)
    finally:
        os.environ.pop("MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT", None)
    main = out["w1"]["main_path"]
    w_check(main["k1"]["tc"] > 0 and main["k2"]["tc"] > 0
            and main["fold"] > 0 and not main["k1"].get("simt")
            and not main["k2"].get("simt"),
            f"w main path (the resumed run): K1 {main['k1']}, K2 "
            f"{main['k2']}, state_fold {main['fold']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[w] phase w {out['seconds']:.1f} s")
    if _W_FAILED:
        raise SystemExit(f"phase w: {len(_W_FAILED)} check(s) failed: "
                         f"{_W_FAILED}")
    return out


# ------------------------------------------------------------------ phase x
# Pod and peer-loss recovery: 4 gloo rank processes on this card train
# phase h / l's LM (bf16 over fp32 masters, Adam 1e-3, B=8 global, T=1024)
# through ShardedTrainer with a pod commit every 2 steps, the fingerprint
# (the fold over several ranks) and an audit every 2 steps; a fault kills
# processes at a step and the survivors must recover and equal, bitwise, a
# fresh job of as many ranks on the shrunk axes that restores the same
# checkpoint (the shrunk-topology oracle).
X_DIR = os.path.join(ROOT, "_pod")          # gitignored: checkpoints, logs
X_RANKS = 4
X_JOIN_S = 400          # one drill's ranks, or its oracle's
X_SAVE_EVERY = 2
X_AUDIT_EVERY = 2
X_COLLECTIVE_S = 120    # the collective watchdog's deadline in the ranks
X_FAULT_EXIT = 42       # resilience.faults.FAULT_EXIT_CODE
# (name, fault, axes, pod hosts, layers, steps, the step the fault kills
# at, victims, benched)
X_DRILLS = (
    ("x1", "host_death", {"fsdp": 2, "dp": 2}, 2, LAYERS, 8, 5, (2, 3), ()),
    ("x2", "coordinator_loss", {"fsdp": 2, "dp": 2}, 2, 2, 4, 3, (0, 1), ()),
    ("x3", "peer_death", {"dp": 4}, None, 2, 4, 3, (3,), (2,)),
)
_X_FAILED = []


def x_check(ok, what):
    log(f"[x] {what}: {'ok' if ok else 'FAIL'}")
    if not ok:
        _X_FAILED.append(what)


def _x_env(cfg):
    env = {"MXNET_TPU_TORCH_CAPTURE": "0",
           "MXNET_TPU_TORCH_HEARTBEAT_DIR": os.path.join(cfg["dir"], "hb"),
           "MXNET_TPU_TORCH_CRASH_DIR": os.path.join(cfg["dir"], "crash"),
           "MXNET_TPU_TORCH_INTEGRITY_AUDIT_EVERY": str(X_AUDIT_EVERY),
           "MXNET_TPU_TORCH_WATCHDOG_COLLECTIVE_TIMEOUT": str(X_COLLECTIVE_S),
           "MXNET_TPU_TORCH_CKPT_COMMIT_TIMEOUT_S": "300"}
    if cfg.get("fault"):
        env["MXNET_TPU_TORCH_FAULTS"] = f"{cfg['fault']}@{cfg['die_at'] - 1}"
        env["MXNET_TPU_TORCH_FAULT_HOST_RANK"] = "1"
        env["MXNET_TPU_TORCH_FAULT_PEER_RANK"] = "3"
    return env


def _x_setup(rank, cfg, tag):
    """A phase-x rank's process: its environment, its output into
    ``<dir>/<tag><rank>.log`` (the parent reads the victims' fault_exit
    lines there), the card, the process group."""
    import torch
    import torch.distributed as dist

    os.environ.update(_x_env(cfg))
    fd = os.open(os.path.join(cfg["dir"], f"{tag}{rank}.log"),
                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    sys.path.insert(0, ROOT)
    if cfg["device"] == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    import datetime

    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(cfg["dir"],
                                                     f"{tag}.rendezvous"),
        world_size=cfg["world"], rank=rank,
        timeout=datetime.timedelta(seconds=X_COLLECTIVE_S))


def _x_sync(torch, cfg):
    if cfg["device"] == "cuda":
        torch.cuda.synchronize()


def _x_trainer(torch, mx, cfg, axes, pod, mesh=None):
    """The LM (seeded Xavier on the device) through ShardedTrainer over
    ``axes``: for_pod with ``pod`` hosts, else for_multihost; SpecLayout's
    fsdp rules, batch over dp x fsdp; a CheckpointManager in the drill's
    ckpt dir."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon.model_zoo import transformer
    from mxnet_tpu_torch.resilience import CheckpointManager

    dev = cfg["device"]
    gen = torch.Generator(device=dev).manual_seed(0)
    net = transformer.transformer_lm(
        vocab=cfg["vocab"], units=cfg["units"], num_heads=cfg["heads"],
        num_layers=cfg["layers"], max_len=cfg["t"], impl="flash",
        prefix="tlm_")
    ctx = mx.gpu(0) if dev == "cuda" else mx.cpu()
    net.initialize(mx.init.Xavier(), ctx=ctx, generator=gen)
    lay = parallel.SpecLayout(data_axis="dp",
                              fsdp_axis="fsdp" if "fsdp" in axes else None,
                              tp_axis=None)
    mgr = CheckpointManager(os.path.join(cfg["dir"], "ckpt"), keep_n=3)
    kw = dict(param_rules=lay.param_rules(), batch_axis_name=lay.batch_axes(),
              checkpoint_manager=mgr, dtype=cfg["dtype"])
    args = (net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
            {"learning_rate": LR})
    devices = [ctx] * cfg["world"]
    if pod:
        topo = parallel.PodTopology.simulated(pod, devices)
        tr = parallel.ShardedTrainer.for_pod(*args, axes=axes, topology=topo,
                                             backend="gloo", devices=devices,
                                             **kw)
        mgr.bind_pod(tr.pod)
    else:
        tr = parallel.ShardedTrainer.for_multihost(
            *args, axes=axes, backend="gloo", devices=devices, **kw)
    return tr, mgr, lay


def _x_batch(torch, cfg, step, index, shards):
    """Step ``step``'s rows of batch index ``index`` of ``shards``: the
    learnable sequence of lm_batch from seed 3000 + step."""
    import numpy as np

    rng = np.random.RandomState(3000 + step)
    seq = np.zeros((cfg["batch"], cfg["t"] + 1), np.int64)
    seq[:, 0] = rng.randint(0, cfg["vocab"], cfg["batch"])
    for i in range(cfg["t"]):
        seq[:, i + 1] = (5 * seq[:, i] + 3) % cfg["vocab"]
    per = cfg["batch"] // shards
    rows = seq[index * per:(index + 1) * per]
    return (torch.from_numpy(rows[:, :-1].copy()).to(cfg["device"]),
            torch.from_numpy(rows[:, 1:].copy()).to(cfg["device"]))


def _x_counts():
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.resilience import integrity

    return {"k1": dict(kernels.flash_attention.launches_by_route),
            "k2": dict(kernels.flash_attention_backward.launches_by_route),
            "fold_sums": integrity.fold_sums.launches,
            "fold_chain": integrity.fold_chain.launches,
            "state_fold": integrity.fold_tree.launches}


def _x_zero():
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.resilience import integrity

    zero_counts(kernels)
    integrity.fold_sums.launches = integrity.fold_chain.launches = 0
    integrity.fold_tree.launches = 0


def _x_fold_probe(torch, tr, x, y, cfg):
    """After step 1, on every rank: the sums kernel over this rank's
    masters and gradients against sums_plain and chain_plain, the sharded
    fold against the one-rank state_fold of the gathered state (rank 0),
    rank 0's sums launch timed alone beside its bound and the sums'
    all-reduce in ms (every rank in step)."""
    from mxnet_tpu_torch.parallel import collectives
    from mxnet_tpu_torch.resilience import integrity

    _, grads = tr._loss_and_mean_grads(x, y, 1)
    named = {f"param:{k}": (k, v) for k, v in tr.params.items()}
    named.update({f"grad:{k}": (k, g) for k, g in grads.items()})
    leaves = {k: v.contiguous() for k, (_, v) in named.items()}
    counted = {k: tr._counted(p) for k, (p, _) in named.items()}
    sums = integrity.fold_sums(leaves, counted)
    plain = integrity.sums_plain(leaves, counted)
    out = {"sums_equal": bool(torch.equal(sums, plain))}
    total = sums.clone()
    collectives.all_reduce(total, tr.mesh, tuple(tr.mesh.axis_names))
    total &= 0xFFFFFFFF
    names = sorted(leaves)
    chain = integrity.as_uint32(integrity.fold_chain(total, names))
    out["chain_equal"] = chain == integrity.as_uint32(integrity.chain_plain(
        total, [integrity._crc(n) for n in names]))
    sharded = integrity.as_uint32(tr._fold(named))
    full = {**{f"param:{k}": v for k, v in tr._full(tr.params).items()},
            **{f"grad:{k}": v for k, v in tr._full(grads).items()}}
    if tr.mesh.rank == 0:
        one = integrity.as_uint32(integrity.fold_tree(
            {k: v.contiguous() for k, v in full.items()}))
        out["one_rank_equal"] = one == sharded == chain
        out["fingerprint"] = sharded
    del full
    nbytes = sum(v.numel() * v.element_size() for k, v in leaves.items()
                 if counted[k])
    out["bytes"] = nbytes
    out["sums_err"] = int((sums - plain).abs().max()) if sums.numel() \
        else 0
    out["chain_err"] = abs(chain - integrity.as_uint32(
        integrity.chain_plain(total, [integrity._crc(n) for n in names])))
    out["n_leaves"] = len(names)
    tr._barrier()
    if tr.mesh.rank == 0 and cfg["device"] == "cuda":
        out["sums_ms"] = device_ms(
            lambda: integrity.fold_sums(leaves, counted), n=20)
        out["bound_ms"] = nbytes / PEAK_BYTES * 1e3
        out["chain_ms"] = device_ms(
            lambda: integrity.fold_chain(total, names), n=20)
        # 16 bytes of sums and 8 of crc32 a leaf read, 4 written
        out["chain_bound_ms"] = (24 * len(names) + 4) / PEAK_BYTES * 1e3

        def host_ms(fn):
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            return sorted(ms)[1]

        out["sums_plain_ms"] = host_ms(
            lambda: integrity.sums_plain(leaves, counted))
        out["chain_plain_ms"] = host_ms(lambda: integrity.chain_plain(
            total, [integrity._crc(n) for n in names]))
    tr._barrier()
    ms = []
    for _ in range(7):
        _x_sync(torch, cfg)
        t0 = time.perf_counter()
        collectives.all_reduce(sums.clone(), tr.mesh,
                               tuple(tr.mesh.axis_names))
        _x_sync(torch, cfg)
        ms.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"] = sorted(ms)[len(ms) // 2]
    return out


def pod_rank(rank, cfg):
    """One rank of a phase-x drill (a spawned process): the steps, the
    commits, the fault, the recovery; its record in
    ``<dir>/result<origin rank>.json`` and its final parameters in
    ``<dir>/final<new rank>.pt``. Ends with os._exit: its old process
    groups may wait on the dead."""
    code = 1
    try:
        _x_setup(rank, cfg, "rank")
        import torch

        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch.resilience import elastic, watchdog

        tr, mgr, lay = _x_trainer(torch, mx, cfg, cfg["axes"], cfg["pod"])
        first = tr.mesh
        shards = first.axis_size(lay.batch_axes())
        index = first.axis_index(lay.batch_axes())
        rec = {"origin": rank, "index": index, "steps": [], "saves": {}}
        for s in range(1, cfg["steps"] + 1):
            x, y = _x_batch(torch, cfg, s, index, shards)
            _x_zero()
            _x_sync(torch, cfg)
            t0 = time.perf_counter()
            loss = tr.step(x, y).item()
            _x_sync(torch, cfg)
            t1 = time.perf_counter()
            row = {"step": s, "loss": loss, "fp": tr.last_fingerprint,
                   "ms": (t1 - t0) * 1e3, "end": time.time(),
                   "gen": tr.mesh.generation, "counts": _x_counts()}
            if tr.last_recovery is not None and "recovered" not in rec:
                rec["recovered"] = dict(tr.recovery_times,
                                        step=s, end=row["end"])
            rec["steps"].append(row)
            if s == 1 and cfg.get("probe"):
                rec["probe"] = _x_fold_probe(torch, tr, x, y, cfg)
            if s % X_SAVE_EVERY == 0:
                mgr.save(s, trainer=tr)
                rec["saves"][s] = dict(mgr.last_save)
                # kept a line a commit: a victim's commits outlive it
                with open(os.path.join(cfg["dir"], f"saves{rank}.jsonl"),
                          "a") as f:
                    f.write(json.dumps(dict(mgr.last_save, rank=rank,
                                            host=_x_host(cfg, rank))) + "\n")
        full = tr._full(tr.params)
        rec.update(rank=tr.mesh.rank, axes=dict(tr.mesh.shape),
                   generation=tr.mesh.generation,
                   restored=None if tr.last_recovery is None
                   else tr.last_recovery.get("step"),
                   shrinks=elastic.stats()["elastic_mesh_shrinks"],
                   recoveries=watchdog.stats()["watchdog_peer_recoveries"],
                   pod=None if tr.pod is None else tr.pod.describe())
        torch.save({k: v.cpu() for k, v in full.items()},
                   os.path.join(cfg["dir"], f"final{tr.mesh.rank}.pt"))
        with open(os.path.join(cfg["dir"], f"result{rank}.json"), "w") as f:
            json.dump(rec, f)
        code = 0
    except BaseException:
        import traceback

        traceback.print_exc()
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


def pod_oracle_rank(rank, cfg):
    """One rank of a drill's shrunk-topology oracle: a fresh job over the
    survivors' axes restores the checkpoint they resumed from and runs the
    same steps, rank i feeding the rows survivor i fed."""
    code = 1
    try:
        _x_setup(rank, cfg, "oracle")
        import torch

        import mxnet_tpu_torch as mx

        tr, mgr, lay = _x_trainer(torch, mx, cfg, cfg["axes"], None)
        mgr.restore(os.path.join(cfg["dir"], "ckpt",
                                 f"ckpt-{cfg['restore']:08d}"), trainer=tr)
        tr._step_count = cfg["restore"]
        rec = {"steps": []}
        for s in range(cfg["restore"] + 1, cfg["steps"] + 1):
            x, y = _x_batch(torch, cfg, s, cfg["rows"][rank],
                            cfg["old_shards"])
            loss = tr.step(x, y).item()
            rec["steps"].append({"step": s, "loss": loss,
                                 "fp": tr.last_fingerprint})
        full = tr._full(tr.params)
        torch.save({k: v.cpu() for k, v in full.items()},
                   os.path.join(cfg["dir"], f"oracle_final{rank}.pt"))
        with open(os.path.join(cfg["dir"], f"oracle{rank}.json"), "w") as f:
            json.dump(rec, f)
        code = 0
    except BaseException:
        import traceback

        traceback.print_exc()
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


def _x_spawn(fn, cfg, world, expect):
    """``world`` processes of ``fn``; waits (X_JOIN_S) and holds each exit
    code to ``expect`` ({rank: code}, default 0); a rank's log tail goes to
    the output when it is not."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(dict(cfg, world=world),),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + X_JOIN_S
    try:
        while any(p.exitcode is None for p in ctx.processes):
            if time.monotonic() > deadline:
                raise SystemExit(f"phase x: {fn.__name__} ranks did not "
                                 f"finish within {X_JOIN_S} s")
            time.sleep(0.1)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    codes = [p.exitcode for p in ctx.processes]
    tag = "rank" if fn is pod_rank else "oracle"
    for r, c in enumerate(codes):
        if c != expect.get(r, 0):
            path = os.path.join(cfg["dir"], f"{tag}{r}.log")
            tail = open(path).read()[-3000:] if os.path.exists(path) else ""
            log(f"[x] {fn.__name__} rank {r} exited {c} (expected "
                f"{expect.get(r, 0)}); its log ends:\n{tail}")
    return codes


def _x_death_time(cfg, victims):
    """The victims' death times, from their fault_exit lines."""
    times = []
    for r in victims:
        path = os.path.join(cfg["dir"], f"rank{r}.log")
        for line in open(path) if os.path.exists(path) else ():
            if line.startswith('{"fault_exit"'):
                times.append(json.loads(line)["time"])
    return times


def x_drill(torch, name, fault, axes, pod, layers, steps, die_at, victims,
            benched, device="cuda", dims=None, probe=False):
    """One drill and its oracle; returns its record (checks through
    x_check)."""
    import shutil

    d = os.path.join(X_DIR, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    vocab, units, heads, t, batch = dims or (VOCAB, UNITS, HEADS, T, BATCH)
    cfg = {"dir": d, "axes": axes, "pod": pod, "layers": layers,
           "steps": steps, "die_at": die_at, "fault": fault,
           "device": device, "vocab": vocab, "units": units, "heads": heads,
           "t": t, "batch": batch, "probe": probe,
           "dtype": "bfloat16" if device == "cuda" else None}
    t0 = time.perf_counter()
    expect = {v: X_FAULT_EXIT for v in victims}
    codes = _x_spawn(pod_rank, cfg, X_RANKS, expect)
    drill_s = time.perf_counter() - t0
    x_check(all(c == expect.get(r, 0) for r, c in enumerate(codes)),
            f"{name} {fault}: exit codes {codes} (victims {list(victims)} "
            f"exit {X_FAULT_EXIT}, benched {list(benched)} exit 0)")
    recs = {}
    for r in range(X_RANKS):
        path = os.path.join(d, f"result{r}.json")
        if os.path.exists(path):
            recs[r] = json.load(open(path))
    survivors = sorted((rec for r, rec in recs.items()),
                       key=lambda rec: rec["rank"])
    want_origins = [r for r in range(X_RANKS)
                    if r not in victims and r not in benched]
    x_check(sorted(recs) == want_origins,
            f"{name} results from ranks {sorted(recs)} (want "
            f"{want_origins}: the benched rank leaves with no result)")
    if not survivors:
        return {"drill_s": drill_s}
    restore = die_at - 1 - (die_at - 1) % X_SAVE_EVERY
    new_axes = survivors[0]["axes"]
    x_check(all(rec["restored"] == restore and rec["generation"] == 1
                and rec["shrinks"] == 1 and rec["recoveries"] == 1
                and rec["axes"] == new_axes for rec in survivors),
            f"{name} survivors {[rec['origin'] for rec in survivors]} -> "
            f"ranks {[rec['rank'] for rec in survivors]} over {new_axes} at "
            f"generation 1, restored step {restore}")
    deaths = _x_death_time(cfg, victims)
    rec0 = survivors[0]
    got = rec0.get("recovered", {})
    detect_s = (got["detected_at"] - min(deaths)) if deaths and got else None
    recover_s = (got["end"] - got["detected_at"]) if got else None
    before = [r["ms"] for r in rec0["steps"]
              if r["step"] < die_at and r["step"] % X_AUDIT_EVERY]
    after = [r["ms"] for r in rec0["steps"]
             if r["step"] > die_at and r["step"] % X_AUDIT_EVERY]
    out = {"drill_s": drill_s, "axes": axes, "new_axes": new_axes,
           "survivors": [rec["origin"] for rec in survivors],
           "detection_s": detect_s, "recovery_s": recover_s,
           "recovery_times": got,
           "step_ms_before": before, "step_ms_after": after,
           "step_ms_all": [r["ms"] for r in rec0["steps"]],
           "commits": _x_commits(cfg), "probe": rec0.get("probe")}
    # the counts of a step without an audit, before the fault: every rank
    # launches as many
    plain_step = next(r for r in rec0["steps"] if r["step"] % X_AUDIT_EVERY)
    out["step_counts"] = plain_step["counts"]
    out["counts_by_step"] = [r["counts"] for r in rec0["steps"]]
    # the oracle
    ocfg = dict(cfg, axes=new_axes, restore=restore,
                rows=[rec["index"] for rec in survivors],
                old_shards=_x_shards(axes), fault=None)
    t1 = time.perf_counter()
    ocodes = _x_spawn(pod_oracle_rank, ocfg, len(survivors), {})
    out["oracle_s"] = time.perf_counter() - t1
    x_check(ocodes == [0] * len(survivors), f"{name} oracle exit codes "
            f"{ocodes}")
    same = ocodes == [0] * len(survivors)
    for i, rec in enumerate(survivors):
        if not same:
            break
        orc = json.load(open(os.path.join(d, f"oracle{i}.json")))
        mine = [r for r in rec["steps"] if r["step"] > restore]
        same &= [r["loss"] for r in mine] == \
            [r["loss"] for r in orc["steps"]]
        same &= [r["fp"] for r in mine] == [r["fp"] for r in orc["steps"]]
        a = torch.load(os.path.join(d, f"final{i}.pt"))
        b = torch.load(os.path.join(d, f"oracle_final{i}.pt"))
        same &= set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    x_check(same, f"{name} survivors' losses, fingerprints and final "
            f"parameters of steps {restore + 1}-{steps} bitwise their "
            f"oracle's ({len(survivors)} fresh ranks over {new_axes} "
            f"restoring step {restore})")
    out["bitwise"] = bool(same)
    return out


def _x_host(cfg, rank):
    """The pod host of global rank ``rank`` when the job began (a rank is
    its own host without a pod)."""
    return rank // (X_RANKS // cfg["pod"]) if cfg["pod"] else rank


def _x_commits(cfg):
    """{step: {host: {"s": the slowest rank's stall, "bytes": the host's
    ranks' payload bytes}}} of the drill's commits, from every rank's
    saves<r>.jsonl (the victims' too)."""
    out = {}
    for r in range(X_RANKS):
        path = os.path.join(cfg["dir"], f"saves{r}.jsonl")
        for line in open(path) if os.path.exists(path) else ():
            rec = json.loads(line)
            cell = out.setdefault(str(rec["step"]), {}).setdefault(
                str(rec["host"]), {"s": 0.0, "bytes": 0, "mode": rec["mode"]})
            cell["s"] = max(cell["s"], rec["stall_s"])
            cell["bytes"] += rec["bytes"]
    return out


def _x_shards(axes):
    n = 1
    for a in ("dp", "fsdp"):
        n *= axes.get(a, 1)
    return n


def pod_phase(torch, mx, card=None, device="cuda", dims=None, layers=None):
    """Phase x: x1 (host death at full depth, the fold probe), x2
    (coordinator loss) and x3 (peer death without a pod, one rank benched),
    each against its oracle."""
    import gc

    t0 = time.perf_counter()
    if device == "cuda":
        # the ranks share the card with this process: what earlier phases
        # left in reference cycles goes before they start
        gc.collect()
        torch.cuda.empty_cache()
    out = {}
    for (name, fault, axes, pod, depth, steps, die_at, victims,
         benched) in X_DRILLS:
        out[name] = x_drill(torch, name, fault, axes, pod,
                            depth if layers is None else layers, steps,
                            die_at, victims, benched, device=device,
                            dims=dims, probe=name == "x1")
        r = out[name]
        log(f"[x] {name} ({fault}, {axes} -> {r.get('new_axes')}): drill "
            f"{r['drill_s']:.1f} s, oracle {r.get('oracle_s', 0):.1f} s; "
            f"detection {r.get('detection_s')} s, recovery "
            f"{r.get('recovery_s')} s ({r.get('recovery_times')}); step ms "
            f"before {r.get('step_ms_before')}, after "
            f"{r.get('step_ms_after')}; commits by step and host "
            f"{r.get('commits')}")
    x1 = out["x1"]
    probe = x1.get("probe") or {}
    x_check(bool(probe.get("sums_equal")) and bool(probe.get("chain_equal"))
            and bool(probe.get("one_rank_equal")),
            f"x1 fold over 4 ranks: state_fold_sums == sums_plain, "
            f"state_fold_chain == chain_plain, both == one-rank state_fold "
            f"of the gathered state ({probe.get('fingerprint')})")
    if device == "cuda":
        c = x1["step_counts"]
        x_check(c["k1"].get("tc", 0) == LAYERS
                and c["k2"].get("tc", 0) == LAYERS
                and not c["k1"].get("simt")
                and not c["k2"].get("simt") and c["fold_sums"] >= 1
                and c["fold_chain"] >= 1,
                f"x1 a step's launches on rank 0: K1 {c['k1']}, K2 "
                f"{c['k2']}, fold sums {c['fold_sums']}, chain "
                f"{c['fold_chain']}")
        log(f"[x] {card}: x1 sums kernel {probe.get('sums_ms')} ms over "
            f"{probe.get('bytes', 0) / 2**30:.3f} GiB (bound "
            f"{probe.get('bound_ms')} ms, bytes); the sums' all-reduce "
            f"{probe.get('allreduce_ms')} ms (host clock, gloo)")
    out["seconds"] = time.perf_counter() - t0
    log(f"[x] phase x {out['seconds']:.1f} s")
    if _X_FAILED:
        raise SystemExit(f"phase x: {len(_X_FAILED)} check(s) failed: "
                         f"{_X_FAILED}")
    return out


def library_ms(fn, what):
    """device_ms of a library call, or None (logged) where the library
    refuses the call."""
    try:
        return device_ms(fn, n=10)
    except RuntimeError as e:
        log(f"[c] {what} refused: {str(e)[:120]} (library time not "
            "measured)")
        return None



def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and run the kernel checks (phase b) only")
    ap.add_argument("--summary", metavar="PATH",
                    help="also write the measurements to PATH as JSON")
    ap.add_argument("--multirank-only", action="store_true",
                    help="build, then run phase o (4 ranks) only")
    ap.add_argument("--int8-only", action="store_true",
                    help="build, then run K5's checks, phase p and K5's "
                         "timing only")
    ap.add_argument("--amp-only", action="store_true",
                    help="build, then run phase q (AMP, optimizers, "
                         "Trainer states) only")
    ap.add_argument("--module-only", action="store_true",
                    help="build, then run phase r (mx.nd, Module, kvstore) "
                         "only")
    ap.add_argument("--rnn-only", action="store_true",
                    help="build, then run phase s (the word-LM slice) only")
    ap.add_argument("--ssd-only", action="store_true",
                    help="build, then run phase t (SSD, detection ops) only")
    ap.add_argument("--dist-only", action="store_true",
                    help="build, then run phase u (dist_sync ranks) only")
    ap.add_argument("--fleet-only", action="store_true",
                    help="build, then run phase v (the serving runtime) "
                         "only")
    ap.add_argument("--resilience-only", action="store_true",
                    help="build, then run the fold's phase-b cases and "
                         "phase w (resilient training) only")
    ap.add_argument("--pod-only", action="store_true",
                    help="build, then run the fold's phase-b cases and "
                         "phase x (pod and peer-loss recovery) only")
    ap.add_argument("--resilience-child", metavar="DIR",
                    help=argparse.SUPPRESS)   # w1's child
    ap.add_argument("--dist-rank", metavar="DIR",
                    help=argparse.SUPPRESS)   # one rank of phase u
    ap.add_argument("--lm-sweeps", type=int, metavar="N",
                    help="build, then train s1's word LM over N sweeps on "
                         "the card and on a CPU copy, log each one's "
                         "perplexity by sweep, and hold every step of the "
                         "card's to the CPU from its state")
    args = ap.parse_args(argv)
    if args.summary:
        GRAPH_DIR.append(os.path.join(
            os.path.dirname(os.path.abspath(args.summary)), "graphs"))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to drive",
              file=sys.stderr)
        return 1
    if args.dist_rank:
        return dist_rank(args.dist_rank)
    if args.resilience_child:
        return resilience_child(args.resilience_child)
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _build, kernels
    from mxnet_tpu_torch.ops import decode_attention as da
    from mxnet_tpu_torch.ops import quantization as q

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
        for line in ptxas_advisories(_build.build_log(name)):
            log(f"[a] ptxas advisory ({name}): {line}")
        for entry, usage in ptxas_usage(_build.build_log(name)):
            log(f"[a] ptxas {entry}: {usage}")
            if name.endswith(("_tc", "_tf32x3", "_int8", "s8_gemm",
                              "_wgmma")) and \
                    not re.search(
                    r"\b0 bytes spill stores, 0 bytes spill loads", usage):
                raise SystemExit(f"phase a: {entry} spills registers")

    if args.multirank_only:
        multirank_phase(torch, mx, kernels)
        log("[multirank-only] phase o passed; phases b-n skipped")
        return 0
    if args.int8_only:
        check_k5(torch, q)
        int8 = int8_serving(torch, mx, q)
        time_k5(torch, q, int8.pop("predictor"), int8.pop("x"))
        log("[int8-only] K5's checks, phase p and K5's timing passed")
        return 0
    if args.amp_only:
        amp_phase(torch, mx, kernels)
        log("[amp-only] phase q passed")
        log(card)
        return 0
    if args.module_only:
        module_phase(torch, mx, kernels)
        log("[module-only] phase r passed")
        log(card)
        return 0
    if args.lm_sweeps:
        word_lm_perplexities(torch, mx, args.lm_sweeps)
        log(card)
        return 0
    if args.rnn_only:
        rnn_phase(torch, mx)
        log("[rnn-only] phase s passed")
        log(card)
        return 0
    if args.ssd_only:
        ssd_phase(torch, mx)
        log("[ssd-only] phase t passed")
        log(card)
        return 0
    if args.dist_only:
        dist_phase(torch, mx)
        log("[dist-only] phase u passed")
        log(card)
        return 0
    if args.fleet_only:
        fleet_phase(torch, mx, kernels, q)
        log("[fleet-only] phase v passed")
        log(card)
        return 0
    if args.resilience_only:
        check_fold(torch)
        resilience_phase(torch, mx)
        log("[resilience-only] phase w passed")
        log(card)
        return 0
    if args.pod_only:
        check_fold(torch)
        pod_phase(torch, mx, card)
        log("[pod-only] phase x passed")
        log(card)
        return 0
    t_run = time.perf_counter()

    def stamp(label):
        log(f"[time] {label} from {time.perf_counter() - t_run:.1f} s after "
            "the builds")

    checks, slice_err, slice_err32 = check_flash(torch, kernels)
    bwd_checks, bwd_slice_err, bwd_slice_err32 = check_flash_bwd(torch,
                                                                 kernels)
    conv_checks = check_conv(torch, kernels)
    dec_checks, dec_errs = check_decode_attention(torch, da)
    write_checks = check_kv_write(torch, da)
    k5_checks = check_k5(torch, q)
    fold_checks = check_fold(torch)
    if args.quick:
        log("[quick] phase b passed; phases c-n skipped")
        return 0
    stamp("time_flash")
    timing = time_flash(torch, kernels)
    bwd_timing = time_flash_bwd(torch, kernels)
    conv_timing = time_conv(torch, kernels)
    dec_timing = time_decode_attention(torch, da)
    write_timing = time_kv_write(torch, da)
    stamp("serve_slice")
    served = serve_slice(torch, mx, kernels)
    model_err = model_vs_plain(torch, mx, kernels)
    vision, (pred, net, images) = serve_resnet(torch, mx)
    on_model = conv_on_model(torch, kernels, pred, net, images)
    on_fp32_model = conv_on_fp32_model(torch, mx, kernels, images)
    del pred, net, images
    torch.cuda.empty_cache()
    layout_err = resnet_layouts(torch, mx)
    stamp("train_slice")
    training = train_slice(torch, mx, kernels)
    train_err = train_vs_plain(torch, mx, kernels)
    resnet_training = train_resnet(torch, mx)
    k3_training = k3_at_training_shapes(
        torch, kernels, RESNET_BATCH, resnet_training["median_step_ms"])
    k3_fp32_training = k3_fp32_at_training_shapes(
        torch, kernels, RESNET_BATCH, resnet_training["median_step_ms"])
    stamp("capture_phase")
    captured = capture_phase(torch, mx, kernels)
    fp32_training = train_fp32_lm(torch, mx, kernels)
    stamp("decode_phase")
    decoding = decode_phase(torch, mx, kernels)
    stamp("int8_serving")
    int8 = int8_serving(torch, mx, q)
    k5_timing = time_k5(torch, q, int8.pop("predictor"), int8.pop("x"))
    stamp("multirank_phase")
    multirank = multirank_phase(torch, mx, kernels)
    rank0 = multirank["per_rank"][0]
    stamp("amp_phase")
    amp = amp_phase(torch, mx, kernels)
    amp_train_run, fp16 = amp["train"], amp["fp16_timing"]
    stamp("module_phase")
    module = module_phase(torch, mx, kernels)
    nd_launches = module["nd"]["sdpa_launches"]
    stamp("rnn_phase")
    word_lm = rnn_phase(torch, mx)
    stamp("ssd_phase")
    ssd = ssd_phase(torch, mx)
    stamp("dist_phase")
    dist_u = dist_phase(torch, mx)
    stamp("fleet_phase")
    fleet_v = fleet_phase(torch, mx, kernels, q)
    stamp("resilience_phase")
    resilience = resilience_phase(torch, mx)
    w3 = resilience["w3"]
    stamp("pod_phase")
    pod = pod_phase(torch, mx, card)
    probe = pod["x1"]["probe"]
    x1_counts = pod["x1"]["counts_by_step"]

    def ring_err(dtype, parts, key="errors"):
        """The ring's largest error (of max|whole-sequence call|, or with
        ``key="plain_errors"`` of max|plain version|) over the ranks,
        causal and full, in ``parts`` of O, dq, dk, dv."""
        return max(r["o1"][f"{dtype}_{c}"][key][g]
                   for r in multirank["per_rank"] for c in ("causal", "full")
                   for g in parts)

    # K3's four launches on each main path are one per ResNet-50 shape, so
    # its totals are over the four shapes at N=32: the bf16 model's (phase
    # g) take the tensor-core source, the fp32 model's the 3xTF32 one, whose
    # numbers the two K3 entries hold (simt_ms: the CUDA-core kernel on the
    # same inputs)
    conv_flops = sum(r["flops"] for r in conv_timing)
    conv_bytes = sum(r["bytes"] for r in conv_timing)
    conv_bound_ms, conv_bound_by = bound(conv_flops, conv_bytes)
    conv32_bound_ms, conv32_bound_by, _ = bound_tf32x3(
        conv_flops, sum(r["fp32_bytes"] for r in conv_timing))
    k3_sources = {"tc": "mxnet_tpu_torch/csrc/conv3x3_bn_stats_tc.cu",
                  "tf32x3": "mxnet_tpu_torch/csrc/conv3x3_bn_stats_tf32x3.cu",
                  "simt": "mxnet_tpu_torch/csrc/conv3x3_bn_stats.cu"}
    # K1 and K2 have three sources each, chosen by a fixed route: the bf16
    # LM's path (phases d, h) takes "tc", whose numbers the first two
    # entries hold; the fp32 LM's path (phase m) takes "tf32x3", whose
    # numbers the last two entries hold; "simt" takes the rest
    k1_sources = {"tc": "mxnet_tpu_torch/csrc/flash_attn_fwd_tc.cu",
                  "tf32x3": "mxnet_tpu_torch/csrc/flash_attn_fwd_tf32x3.cu",
                  "simt": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu"}
    k2_sources = {"tc": "mxnet_tpu_torch/csrc/flash_attn_bwd_tc.cu",
                  "tf32x3": "mxnet_tpu_torch/csrc/flash_attn_bwd_tf32x3.cu",
                  "simt": "mxnet_tpu_torch/csrc/flash_attn_bwd.cu"}
    record = {"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attn_fwd_tc.cu",
        "sources": k1_sources,
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:149",
        "launches": served["launches"],
        "launches_by_route": served["launches_by_route"],
        "max_abs_err": slice_err,
        "check": f"{len(checks)} cases within tolerance",
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "strided_ms": timing["strided_ms"],
        "simt_fp32_ms": timing["simt_fp32_ms"],
        "fp32_plain_ms": timing["fp32_plain_ms"],
        "fp32_library_ms": timing["fp32_library_ms"],
        "training_launches": training["k1_launches"],
        "training_launches_by_route": training["k1_launches_by_route"],
        # phase o: the ring's hops (rank 0; every rank launches as many)
        "ring_launches_by_route": rank0["o1"]["bfloat16_causal"][
            "k1_launches_by_route"],
        "ring_lm_launches_by_route": rank0["o4"]["bfloat16"][
            "k1_launches_by_route"],
        "ring_lm_remat_launches_by_route": rank0["o4"]["bfloat16_remat"][
            "k1_launches_by_route"],
        # phase o6 / o7: a tensor-parallel step's launches on each rank's
        # heads (every rank launches as many)
        "tp_launches_per_step": {o: rank0[o]["k1_launches_per_step"]
                                 for o in ("o6", "o7")},
        "tp_launch_shapes": {o: rank0[o]["launch_shapes"]
                             for o in ("o6", "o7")},
        "ring_max_abs_err": ring_err("bfloat16", ("out",)),
        "ring_plain_max_abs_err": ring_err("bfloat16", ("out",),
                                           "plain_errors"),
        "ring_device_ms": rank0["o1"]["device_ms"]["bfloat16"],
        "whole_sequence_k1_ms": multirank["whole_sequence_ms"][
            "bfloat16"]["k1_ms"],
        "whole_sequence_plain_k1_ms": multirank["whole_sequence_ms"][
            "bfloat16"]["plain_k1_ms"],
        "ring_k1_k2_bound_ms": multirank["whole_sequence_ms"]["bfloat16"][
            "bound"][0],
        "ring_library_ms": multirank["whole_sequence_ms"]["bfloat16"][
            "sdpa_ms"],
        # phase q1: the AMP fp16 step's launches, 12 a step on "tc" with
        # fp16 q / k / v; fp16 times at the LM's shape
        "amp_fp16_launches": amp_train_run["k1_launches"],
        "amp_fp16_launches_by_route": amp_train_run["k1_launches_by_route"],
        "fp16_ms": fp16["k1"]["ms"], "fp16_plain_ms": fp16["k1"]["plain_ms"],
        "fp16_bound_ms": fp16["k1"]["bound_ms"],
        "fp16_library_ms": fp16["k1"]["library_ms"],
        # phase r3: one mx.nd.scaled_dot_product_attention(impl='flash')
        # forward and backward at the LM's shape in bf16
        "imperative_launches": nd_launches["k1"],
        "imperative_launches_by_route": nd_launches["k1_by_route"],
        # phase v1: the fleet's replicas, its reference and every restart
        # (2 warm-up runs and the capture of each bucket; replays add none)
        "fleet_launches_by_route": fleet_v["v1"]["k1_launches_by_route"]},
        {
        "name": "flash_attn_bwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attn_bwd_tc.cu",
        "sources": k2_sources,
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:241",
        "launches": training["k2_launches"],
        "launches_by_route": training["k2_launches_by_route"],
        "launches_per_step": training["k2_launches"] / TRAIN_STEPS,
        "max_abs_err": bwd_slice_err,
        "check": f"{len(bwd_checks)} cases within tolerance",
        "ms": bwd_timing["ms"], "plain_ms": bwd_timing["plain_ms"],
        "bound_ms": bwd_timing["bound_ms"],
        "bound_by": bwd_timing["bound_by"],
        "library_ms": bwd_timing["library_ms"],
        "lm_layout_ms": bwd_timing["lm_layout_ms"],
        "issued_flops": bwd_timing["issued_flops"],
        "tflops": bwd_timing["tflops"],
        "issued_tflops": bwd_timing["issued_tflops"],
        "simt_ms": bwd_timing["simt_ms"],
        "fp32_ms": bwd_timing["fp32_ms"],
        "fp32_plain_ms": bwd_timing["fp32_plain_ms"],
        "fp32_library_ms": bwd_timing["fp32_library_ms"],
        "ring_launches_by_route": rank0["o1"]["bfloat16_causal"][
            "k2_launches_by_route"],
        "ring_lm_launches_by_route": rank0["o4"]["bfloat16"][
            "k2_launches_by_route"],
        "tp_launches_per_step": {o: rank0[o]["k2_launches_per_step"]
                                 for o in ("o6", "o7")},
        "ring_max_abs_err": ring_err("bfloat16", ("dq", "dk", "dv")),
        "ring_plain_max_abs_err": ring_err("bfloat16", ("dq", "dk", "dv"),
                                           "plain_errors"),
        "whole_sequence_k2_ms": multirank["whole_sequence_ms"][
            "bfloat16"]["k2_ms"],
        "whole_sequence_plain_k2_ms": multirank["whole_sequence_ms"][
            "bfloat16"]["plain_k2_ms"],
        "amp_fp16_launches": amp_train_run["k2_launches"],
        "amp_fp16_launches_by_route": amp_train_run["k2_launches_by_route"],
        "fp16_ms": fp16["k2"]["ms"], "fp16_plain_ms": fp16["k2"]["plain_ms"],
        "fp16_bound_ms": fp16["k2"]["bound_ms"],
        "fp16_library_ms": fp16["k2"]["library_ms"],
        "imperative_launches": nd_launches["k2"],
        "imperative_launches_by_route": nd_launches["k2_by_route"]}, {
        "name": "conv3x3_bn_stats", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/conv3x3_bn_stats_tc.cu",
        "sources": k3_sources,
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:446",
        "launches": on_model["launches"],
        "launches_by_route": on_model["launches_by_route"],
        "max_abs_err": on_model["max_abs_err"],
        "check": f"{len(conv_checks)} cases and the model's 4 tensors "
                 "within tolerance",
        "ms": sum(r["ms"] for r in conv_timing),
        "plain_ms": sum(r["plain_ms"] for r in conv_timing),
        "bound_ms": conv_bound_ms, "bound_by": conv_bound_by,
        "library_ms": sum(r["library_ms"] for r in conv_timing),
        "simt_ms": sum(r["simt_ms"] for r in conv_timing),
        "unfused_ms": sum(r["unfused_ms"] for r in conv_timing),
        "per_shape": [{k: r[k] for k in (
            "shape", "tiles", "ms", "simt_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "unfused_ms")}
            for r in conv_timing],
        # phase k: the trainable wrapper at the training step's shapes
        "training_shape_launches": k3_training["launches"],
        "training_shape": [{k: r[k] for k in (
            "shape", "count", "fwd_ms", "unfused_fwd_ms", "plain_k3_ms",
            "fwd_bwd_ms", "unfused_fwd_bwd_ms", "bound_ms", "bound_by")}
            for r in k3_training["per_shape"]],
        "training_saved_fwd_bwd_ms": k3_training["saved_fwd_bwd_ms"]}, {
        # the fp32 ResNet-50's path (phase g): 4 launches on route "tf32x3"
        "name": "conv3x3_bn_stats_tf32x3", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/conv3x3_bn_stats_tf32x3.cu",
        "sources": k3_sources,
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:446",
        "launches": on_fp32_model["launches"],
        "launches_by_route": on_fp32_model["launches_by_route"],
        "max_abs_err": on_fp32_model["max_abs_err"],
        "check": "the fp32 cases of phase b and the fp32 model's 4 tensors "
                 f"within {CONV_TF32X3_TOL:g} of max|ref|",
        "ms": sum(r["tf32x3_ms"] for r in conv_timing),
        "plain_ms": sum(r["fp32_plain_ms"] for r in conv_timing),
        "bound_ms": conv32_bound_ms, "bound_by": conv32_bound_by,
        "library_ms": sum(r["fp32_library_ms"] for r in conv_timing),
        "tf32_library_ms": sum(r["tf32_library_ms"] for r in conv_timing),
        "unfused_ms": sum(r["fp32_unfused_ms"] for r in conv_timing),
        "simt_ms": sum(r["simt_fp32_ms"] for r in conv_timing),
        "issued_flops": sum(r["tf32x3_issued_flops"] for r in conv_timing),
        "per_shape": [{k: r[k] for k in (
            "shape", "tf32x3_ms", "simt_fp32_ms", "fp32_plain_ms",
            "fp32_library_ms", "tf32_library_ms", "fp32_unfused_ms",
            "tf32x3_bound_ms", "tf32x3_issued_flops")}
            for r in conv_timing],
        # phase k in fp32: the trainable wrapper at the training step's
        # shapes
        "training_shape_launches": k3_fp32_training["launches"],
        "training_shape": [{k: r[k] for k in (
            "shape", "count", "fwd_ms", "unfused_fwd_ms", "plain_k3_ms",
            "fwd_bwd_ms", "unfused_fwd_bwd_ms", "bound_ms", "bound_by")}
            for r in k3_fp32_training["per_shape"]],
        "training_saved_fwd_bwd_ms": k3_fp32_training["saved_fwd_bwd_ms"]}, {
        # phase m's path: the fp32 LM's 12 K1 and 12 K2 launches a step
        "name": "flash_attn_fwd_tf32x3", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attn_fwd_tf32x3.cu",
        "sources": k1_sources,
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:149",
        "launches": fp32_training["k1_launches"],
        "launches_by_route": fp32_training["k1_launches_by_route"],
        "max_abs_err": slice_err32,
        "check": "the fp32 cases of phase b within 1e-4",
        "ms": timing["tf32x3_ms"], "plain_ms": timing["fp32_plain_ms"],
        "bound_ms": timing["tf32x3_bound_ms"],
        "bound_by": timing["tf32x3_bound_by"],
        "library_ms": timing["fp32_library_ms"],
        "strided_ms": timing["tf32x3_strided_ms"],
        "simt_ms": timing["simt_fp32_ms"],
        "step_device_ms": fp32_training["profile"]["k1_ms"],
        "ring_launches_by_route": rank0["o1"]["float32_causal"][
            "k1_launches_by_route"],
        "ring_lm_launches_by_route": rank0["o4"]["float32"][
            "k1_launches_by_route"],
        "tp_launches_by_route": rank0["o6"]["float32"][
            "k1_launches_by_route"],
        "ring_max_abs_err": ring_err("float32", ("out",)),
        "ring_plain_max_abs_err": ring_err("float32", ("out",),
                                           "plain_errors"),
        "ring_device_ms": rank0["o1"]["device_ms"]["float32"],
        "whole_sequence_k1_ms": multirank["whole_sequence_ms"][
            "float32"]["k1_ms"],
        "whole_sequence_plain_k1_ms": multirank["whole_sequence_ms"][
            "float32"]["plain_k1_ms"],
        "ring_k1_k2_bound_ms": multirank["whole_sequence_ms"]["float32"][
            "bound"][0],
        "ring_library_ms": multirank["whole_sequence_ms"]["float32"][
            "sdpa_ms"]}, {
        "name": "flash_attn_bwd_tf32x3", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attn_bwd_tf32x3.cu",
        "sources": k2_sources,
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:241",
        "launches": fp32_training["k2_launches"],
        "launches_by_route": fp32_training["k2_launches_by_route"],
        "max_abs_err": bwd_slice_err32,
        "check": "the fp32 cases of phase b within 1e-4 of max|ref|",
        "ms": bwd_timing["fp32_ms"], "plain_ms": bwd_timing["fp32_plain_ms"],
        "bound_ms": bwd_timing["tf32x3_bound_ms"],
        "bound_by": bwd_timing["tf32x3_bound_by"],
        "library_ms": bwd_timing["fp32_library_ms"],
        "lm_layout_ms": bwd_timing["fp32_lm_layout_ms"],
        "simt_ms": bwd_timing["simt_fp32_ms"],
        "step_device_ms": fp32_training["profile"]["k2_ms"],
        "ring_launches_by_route": rank0["o1"]["float32_causal"][
            "k2_launches_by_route"],
        "ring_lm_launches_by_route": rank0["o4"]["float32"][
            "k2_launches_by_route"],
        "tp_launches_by_route": rank0["o6"]["float32"][
            "k2_launches_by_route"],
        "ring_max_abs_err": ring_err("float32", ("dq", "dk", "dv")),
        "ring_plain_max_abs_err": ring_err("float32", ("dq", "dk", "dv"),
                                           "plain_errors"),
        "whole_sequence_k2_ms": multirank["whole_sequence_ms"][
            "float32"]["k2_ms"],
        "whole_sequence_plain_k2_ms": multirank["whole_sequence_ms"][
            "float32"]["plain_k2_ms"]}] + [{
        # phase n's paths: the decode step's 12 K4 launches (enqueued at
        # its 2 warm-up runs and its capture; replays add none), the fp32
        # pool's on csrc/paged_decode_attn.cu, the int8 pool's on route
        # "int8_bulk"; times from phase c at the slice's shape, bf16 q
        "name": name, "route": "cuda", "source": f"mxnet_tpu_torch/{src}",
        "replaces": "mxnet_tpu/ops/decode_attention.py:55",
        "kv_dtype": kv, "k4_route": DECODE_ROUTE[kv],
        "launches": decoding[kv]["launches"],
        "launches_by_route": decoding[kv]["launches_by_route"],
        "max_abs_err": dec_errs[DECODE_ROUTE[kv]],
        "check": f"{sum(c['route'] == DECODE_ROUTE[kv] for c in dec_checks)}"
                 " cases of "
                 f"phase b: fp32 q within {DECODE_TOL:g} of max|ref|, "
                 f"16-bit q within {DECODE_ULP} ulp; length-0 rows 0",
        "ms": dec_timing[DECODE_ROUTE[kv]]["ms"],
        "plain_ms": dec_timing[DECODE_ROUTE[kv]]["plain_ms"],
        "bound_ms": dec_timing[DECODE_ROUTE[kv]]["bound_ms"],
        "bound_by": dec_timing[DECODE_ROUTE[kv]]["bound_by"],
        # no PyTorch call takes a page table; the same attention over KV
        # already contiguous, as one SDPA call, stands beside it
        "library_ms": None,
        "contiguous_sdpa_fp32_ms": dec_timing[DECODE_ROUTE[kv]][
            "contiguous_sdpa_fp32_ms"],
        "contiguous_sdpa_bf16_ms": dec_timing[DECODE_ROUTE[kv]][
            "contiguous_sdpa_bf16_ms"],
        "step_position_ms": dec_timing[DECODE_ROUTE[kv]]["step_position_ms"],
        "step_device_ms": decoding[kv]["step"]["k4_ms"],
        "step_share": decoding[kv]["step"]["k4_share"],
        # phase v5: the StreamRouter's 3 predictor builds (fp32 KV only)
        **({"fleet_launches_by_route":
            fleet_v["v5"]["k4_launches_by_route"]}
           if kv == "float32" else {}),
        # the same source's int8 instance (route "int8": D off a multiple
        # of 16, misaligned pools), timed on the int8 pools of phase c
        **({"int8_route_ms": dec_timing["int8"]["ms"],
            "int8_route_step_position_ms":
                dec_timing["int8"]["step_position_ms"],
            "int8_route_max_abs_err": dec_errs["int8"]}
           if kv == "float32" else {})}
        for kv, name, src in (
            ("float32", "paged_decode_attn", "csrc/paged_decode_attn.cu"),
            ("int8", "paged_decode_attn_int8",
             "csrc/paged_decode_attn_int8.cu"))] + [{
        # phase n's int8 path: one launch a layer in every prefill bucket
        # and the step (enqueued at their warm-up runs and captures)
        "name": "kv_quantize_write", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/kv_quantize_write.cu",
        "replaces": "mxnet_tpu/ops/decode_attention.py:35 (kv_quantize) and "
                    "mxnet_tpu/gluon/model_zoo/transformer.py:202 (the page "
                    "scatter)",
        "launches": decoding["int8"]["write_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in write_checks),
        "check": f"{len(write_checks)} cases of phase b bitwise equal to "
                 "the plain version; bytes outside the written slots "
                 "unchanged",
        "ms": write_timing["ms"], "plain_ms": write_timing["plain_ms"],
        "bound_ms": write_timing["bound_ms"],
        "bound_by": write_timing["bound_by"], "library_ms": None,
        "step_device_ms": decoding["int8"]["step"]["write_ms"],
        "step_launches": decoding["int8"]["step"]["write_launches"]}] + [{
        # phase p's path: the int8 ResNet-18's 20 convs, its FC and 36
        # requantize steps in every bucket program (enqueued at each
        # bucket's 2 warm-up runs and its capture; replays add none); the
        # convs and the FC on csrc/s8_gemm_wgmma.cu (route "wgmma";
        # csrc/s8_gemm.cu, route "mma_s8", takes none of them and is timed
        # beside it); times from phase c at bucket 128's shapes, summed
        # over the calls of one predict
        "name": name, "route": "cuda", "source": f"mxnet_tpu_torch/{src}",
        "replaces": f"mxnet_tpu/ops/quantization.py:{line}",
        "launches": int8["launches"][key],
        "launches_per_predict": int8["launches_per_predict"][key],
        "max_abs_err": max([r["max_abs_err"] for r in k5_checks
                            if r["case"].startswith(prefix)]
                           + [k5_timing["path_errs"][kind]]),
        "check": f"{sum(r['case'].startswith(prefix) for r in k5_checks)} "
                 f"cases of phase b and the "
                 f"{k5_timing['path_calls'][kind]} calls of one bucket-128 "
                 f"predict on the path's own inputs {how}",
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t.get("bound_by", "bytes"), "library_ms": lib,
        **extra}
        for name, src, line, key, prefix, kind, how, t, lib, extra in (
            ("s8_gemm_wgmma", "csrc/s8_gemm_wgmma.cu", 190, "s8_conv",
             "s8_conv [", "conv",
             "exactly equal (int32) to the float64 plain version",
             k5_timing["conv"], k5_timing["conv"]["int_mm_ms"],
             {"entry_point": "s8_wgmma_conv (after s8_wgmma_prep)",
              "launches_by_route": int8["launches"]["conv_by_route"],
              # phase v4: the int8 variant's predictors and its restart
              "fleet_launches": fleet_v["v4"]["k5_launches"],
              "prep_ms": k5_timing["conv"]["prep_ms"],
              "product_ms": k5_timing["conv"]["product_ms"],
              "mma_s8_ms": k5_timing["conv"]["mma_s8_ms"],
              "mma_s8_source": "mxnet_tpu_torch/csrc/s8_gemm.cu",
              "cudnn_bf16_ms": k5_timing["conv"]["cudnn_bf16_ms"],
              "per_shape": k5_timing["conv"]["per_shape"]}),
            ("s8_gemm_wgmma_matmul", "csrc/s8_gemm_wgmma.cu", 174,
             "s8_matmul", "s8_matmul", "fc",
             "exactly equal (int32) to the float64 plain version",
             k5_timing["fc"], k5_timing["fc"]["library_ms"],
             {"entry_point": "s8_wgmma_matmul",
              "launches_by_route": int8["launches"]["matmul_by_route"],
              "mma_s8_ms": k5_timing["fc"]["mma_s8_ms"],
              "mma_s8_source": "mxnet_tpu_torch/csrc/s8_gemm.cu"}),
            ("requant_int8", "csrc/requant_int8.cu", 207, "requant_int8",
             "requant_int8", "requant", "bitwise equal to the plain version "
             "(phase b on both paths and in the three modes)",
             k5_timing["requant"], None,
             {"launches_by_mode": int8["launches"]["requant_by_mode"],
              "random_ms": k5_timing["requant"]["random_ms"],
              "calls_by_mode": k5_timing["requant"]["calls_by_mode"],
              "kernel_bytes": k5_timing["requant"]["kernel_bytes"],
              "sweep_shape": k5_timing["requant"]["sweep_shape"],
              "sweep_ms": k5_timing["requant"]["sweep_ms"],
              "per_shape": k5_timing["requant"]["per_shape"]}),
            # the 19 conv -> [relu] -> requantize chains the executor's
            # plan fuses: s8_wgmma_conv with epilogue "requant" (8) or
            # "range" (11, then requant_int8 reading the word, timed with
            # it); no one PyTorch call does a conv and a requantize
            ("s8_conv_requant", "csrc/s8_gemm_wgmma.cu", "190 and :207",
             "s8_conv_requant", "s8_conv_requant", "chains",
             "bitwise equal to the plain chain (conv, relu, requantize; "
             "the range words to requant_range_reference)",
             k5_timing["fused"], None,
             {"entry_point": "s8_wgmma_conv, epilogue requant or range",
              "launches_by_mode": int8["launches"]["fused_by_mode"],
              "unfused_ms": k5_timing["fused"]["unfused_ms"],
              "per_shape": k5_timing["fused"]["per_shape"]}))] + [{
        # phase w's path: the step fingerprint of the resumed run (w1), one
        # launch (two kernels: partials, combine) at each of its graph's
        # 2 warm-up runs and capture; times from w3 over the LM's fp32
        # masters and gradients
        "name": "state_fold", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/state_fold.cu",
        "replaces": "mxnet_tpu/resilience/integrity.py:236",
        "launches": resilience["w1"]["main_path"]["fold"],
        "launches_by_path": {
            "w1": resilience["w1"]["main_path"]["fold"],
            "x1_rank0": sum(c["state_fold"] for c in x1_counts)},
        "max_abs_err": max([r["max_abs_err"] for r in fold_checks]
                           + [w3["fold_err"]]),
        "check": f"{len(fold_checks)} cases of phase b and the LM's whole "
                 "state bitwise equal to the plain version and fold_host",
        "ms": w3["fold_ms"], "plain_ms": w3["fold_plain_ms"],
        "bound_ms": w3["fold_bound_ms"], "bound_by": "bytes",
        "library_ms": None, "state_bytes": w3["fold_bytes"]}] + [{
        # phase x1's path: the step fingerprint and the audit over 4 (then
        # 2) ranks, rank 0's launches over the drill's 8 steps; times from
        # x1's probe over rank 0's shard set (its masters and gradients)
        "name": "state_fold_sums", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/state_fold.cu",
        "entry_point": "state_fold_sums",
        "replaces": "mxnet_tpu/resilience/integrity.py:236",
        "launches": sum(c["fold_sums"] for c in x1_counts),
        "max_abs_err": probe["sums_err"],
        "check": "rank 0's sums exactly sums_plain's; the fold over 4 "
                 "ranks equal to one-rank state_fold of the gathered state",
        "ms": probe["sums_ms"], "plain_ms": probe["sums_plain_ms"],
        "plain_ms_clock": "host", "bound_ms": probe["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "state_bytes": probe["bytes"],
        "allreduce_ms": probe["allreduce_ms"]}, {
        "name": "state_fold_chain", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/state_fold.cu",
        "entry_point": "state_fold_chain",
        "replaces": "mxnet_tpu/resilience/integrity.py:236",
        "launches": sum(c["fold_chain"] for c in x1_counts),
        "max_abs_err": probe["chain_err"],
        "check": "exactly chain_plain's over the all-reduced sums",
        "ms": probe["chain_ms"], "plain_ms": probe["chain_plain_ms"],
        "plain_ms_clock": "host", "bound_ms": probe["chain_bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "leaves": probe["n_leaves"]}]}
    stamp("the end")
    kind = torch.cuda.get_device_name(0)
    if args.summary:
        os.makedirs(os.path.dirname(os.path.abspath(args.summary)),
                    exist_ok=True)
        with open(args.summary, "w") as f:
            json.dump({"card": card, "kind": kind, "kernel_checks": checks,
                       "bwd_checks": bwd_checks, "bwd_timing": bwd_timing,
                       "training": training, "train_vs_plain": train_err,
                       "conv_checks": conv_checks, "timing": timing,
                       "conv_timing": conv_timing, "slice": served,
                       "model_vs_plain_err": model_err, "vision": vision,
                       "conv_on_model": on_model,
                       "conv_on_fp32_model": on_fp32_model,
                       "resnet_layout_err": layout_err,
                       "resnet_training": resnet_training,
                       "k3_training": k3_training,
                       "k3_fp32_training": k3_fp32_training,
                       "capture": captured,
                       "fp32_training": fp32_training,
                       "decode_checks": dec_checks,
                       "decode_timing": dec_timing, "decode": decoding,
                       "write_checks": write_checks,
                       "write_timing": write_timing,
                       "multirank": multirank,
                       "k5_checks": k5_checks, "int8": int8,
                       "k5_timing": k5_timing, "amp": amp,
                       "module": module, "word_lm": word_lm,
                       "ssd": ssd, "dist": dist_u, "fleet": fleet_v,
                       "fold_checks": fold_checks,
                       "resilience": resilience, "pod": pod,
                       **record}, f,
                      indent=1)
    log(card)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
