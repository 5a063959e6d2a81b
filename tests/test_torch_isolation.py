"""The PyTorch port stands alone: no JAX, nothing of mxnet_tpu, no quiet
move to the CPU, and no kernel launch counted for a CPU tensor."""
import os
import re
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import serving  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import transformer as tzoo  # noqa: E402
from mxnet_tpu_torch.ops import _build, kernels  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mxnet_tpu_torch")

# `mxnet_tpu` not followed by `_torch`: the port's own name starts with it
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|mxnet_tpu(?!_torch)\b)",
    re.MULTILINE)


def _port_sources():
    """The package, chip_smoke.py and the port's tools (tools/torch_*.py)."""
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    tools = os.path.join(ROOT, "tools")
    out += [os.path.join(tools, f) for f in sorted(os.listdir(tools))
            if f.startswith("torch_") and f.endswith(".py")]
    return out


def test_no_source_imports_jax_or_the_jax_package():
    sources = _port_sources()
    assert {"torch_k1_variants.py", "torch_k3_variants.py"} <= {
        os.path.basename(p) for p in sources}
    # the training frontend's modules, the amp package among them
    assert {os.path.join("amp", f) for f in (
        "__init__.py", "amp.py", "lists.py", "loss_scaler.py")} | {
        "optimizer/optimizer.py", "parallel/optim.py", "gluon/loss.py",
        "gluon/trainer.py", "metric.py", "autograd.py"} | {
        # the imperative and Module front end
        "ndarray/__init__.py", "ndarray/ndarray.py", "random.py",
        "ops/random_ops.py", "ops/parity_aliases.py", "attribute.py",
        "kvstore/kvstore.py", "model.py", "callback.py",
        "module/base_module.py", "module/module.py"} | {
        # the word-LM slice
        "ops/rnn.py", "ops/control_flow.py", "symbol/contrib.py",
        "ndarray/contrib.py", "gluon/rnn/rnn_layer.py",
        "gluon/rnn/rnn_cell.py", "gluon/utils.py",
        "module/bucketing_module.py", "module/sequential_module.py",
        "module/python_module.py"} | {
        # the SSD and dist_sync slice, the launcher among them
        "ops/detection.py", "ops/image_ops.py", "ndarray/image.py",
        "image/__init__.py", "image/image.py", "image/detection.py",
        "gluon/data/__init__.py", "gluon/data/dataset.py",
        "gluon/data/sampler.py", "gluon/data/dataloader.py",
        "gluon/data/vision/__init__.py", "gluon/data/vision/datasets.py",
        "gluon/data/vision/transforms.py", "kvstore/dist.py",
        "kvstore/launch.py"} <= {
        os.path.relpath(p, PKG) for p in sources}
    offenders = []
    for path in sources:
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: "
                                 f"{m.group(0).strip()}")
    assert not offenders, offenders
    assert _FORBIDDEN.search("from mxnet_tpu.ops import nn")
    assert not _FORBIDDEN.search("from mxnet_tpu_torch.ops import nn")


def test_imports_and_runs_with_jax_and_mxnet_tpu_blocked():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "mxnet_tpu"):
            sys.modules[name] = None      # any import of them now fails
        import torch
        import mxnet_tpu_torch as mt
        mods = [m.name for m in pkgutil.walk_packages(
            mt.__path__, "mxnet_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        from mxnet_tpu_torch.gluon.model_zoo import transformer
        net = transformer.transformer_lm(vocab=32, units=16, num_heads=2,
                                         num_layers=1, max_len=16,
                                         impl="flash")
        net.initialize(ctx=mt.cpu())
        out = net(torch.randint(0, 32, (2, 8)))
        assert out.shape == (2, 8, 32) and torch.isfinite(out).all()
        from mxnet_tpu_torch.gluon.model_zoo import vision
        cnn = vision.resnet18_v1(layout="NHWC", stem="s2d", classes=4)
        cnn.initialize(mt.init.Xavier(), ctx=mt.cpu())
        with torch.inference_mode():
            logits = cnn(torch.rand(1, 3, 32, 32))
        assert logits.shape == (1, 4) and torch.isfinite(logits).all()
        # the training frontend: an AMP fp16 LAMB step, saved states
        import io, pickle
        mt.amp.init("float16")
        tr = mt.gluon.Trainer(net.collect_params(), "lamb")
        mt.amp.init_trainer(tr)
        with mt.autograd.record():
            loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()(
                net(torch.randint(0, 32, (2, 8))),
                torch.randint(0, 32, (2, 8))).mean()
        with mt.amp.scale_loss(loss, tr) as scaled:
            scaled.backward()
        assert mt.amp.unscale(tr)
        tr.step(2)
        assert pickle.loads(tr.get_states_bytes())["__update_counts__"]
        mt.amp.reset()
        # the imperative and Module front end
        import numpy as np
        with mt.cpu():
            x = mt.nd.random.normal(shape=(32, 8))
            x.attach_grad()
            with mt.autograd.record():
                y = mt.nd.FullyConnected(x, mt.nd.ones((4, 8)), num_hidden=4,
                                         no_bias=True).sum()
            y.backward()
            assert x.grad.shape == (32, 8)
            s = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
                mt.sym.Variable("data"), num_hidden=3), name="softmax")
            mod = mt.mod.Module(s, context=mt.cpu())
            mod.fit(mt.io.NDArrayIter(x.asnumpy(), np.arange(32) % 3, 8),
                    num_epoch=1, kvstore="device",
                    batch_end_callback=mt.callback.Speedometer(8, 2))
        # the SSD and dist_sync slice: detection ops on the hybrid path,
        # the image iterator's augmenters, the data loader, a dist store
        import os as _os
        with mt.cpu():
            f = mt.nd.zeros((1, 4, 4, 4))
            anc = mt.nd.contrib.MultiBoxPrior(f, sizes=(0.5,))
            cp = mt.nd.softmax(mt.nd.ones((1, 2, 16)), axis=1)
            lab = mt.nd.array(np.array([[[0, .1, .1, .5, .5]]]))
            mt.nd.contrib.MultiBoxTarget(anc, lab, cp,
                                         negative_mining_ratio=3.0)
            det = mt.nd.contrib.MultiBoxDetection(cp, mt.nd.zeros((1, 64)),
                                                  anc, nms_topk=8)
            assert det.shape == (1, 16, 6)
            im, lb = mt.image.DetHorizontalFlipAug(1.0)(
                np.zeros((8, 8, 3), np.float32), np.array([[0, .1, .1, .5,
                                                            .5]]))
            T = mt.gluon.data.vision.transforms
            ds = mt.gluon.data.ArrayDataset(
                mt.nd.array(np.zeros((4, 8, 8, 3)), dtype="uint8"),
                np.arange(4)).transform_first(T.ToTensor())
            xb, yb = next(iter(mt.gluon.data.DataLoader(ds, batch_size=2)))
            assert xb.shape == (2, 3, 8, 8)
            assert mt.kv.create("dist_sync").num_workers == 1
        leaked = [n for n in sys.modules
                  if n == "jax" or n.startswith("jax.")
                  or n == "mxnet_tpu" or n.startswith("mxnet_tpu.")]
        assert all(sys.modules[n] is None for n in leaked), leaked
        print("OK", len(mods))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")
    assert int(res.stdout.split()[1]) >= 24


def test_entry_points_without_ctx_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default context works")
    assert mt.current_context() == mt.gpu(0)
    net = tzoo.transformer_lm(vocab=16, units=8, num_heads=2, num_layers=1,
                              max_len=8)
    with pytest.raises(mt.MXNetError, match="CUDA"):
        net.initialize()
    net.initialize(ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="CUDA"):
        serving.Predictor.from_block(net, input_shapes={"data": (8,)})
    with mt.cpu():
        serving.Predictor.from_block(net, input_shapes={"data": (8,)},
                                     batch_sizes=(1,))
    with pytest.raises(mt.MXNetError):
        mt.tpu()


def test_cpu_flash_counts_no_launch_and_builds_nothing():
    before = kernels.flash_attention.launches
    q = torch.randn(1, 2, 40, 16)
    kernels.flash_attention(q, q, q, causal=True)
    assert kernels.flash_attention.launches == before
    assert "flash_attn_fwd" not in _build._libs


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(mt.MXNetError, match="nvcc"):
        _build._nvcc()
