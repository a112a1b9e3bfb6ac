"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package — not at import time and not lazily inside a function — and it
never lands on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
print("\\n".join(sorted(sys.modules)))
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    mods = out.stdout.split()
    for mod in ("paddle_tpu_torch.serving.paged",
                "paddle_tpu_torch.serving.speculative",
                "paddle_tpu_torch.kernels._build",
                "paddle_tpu_torch.kernels.flash_attention",
                "paddle_tpu_torch.optimizer", "paddle_tpu_torch.jit",
                "paddle_tpu_torch.quantization",
                "paddle_tpu_torch.kernels.rms_norm",
                "paddle_tpu_torch.flags", "paddle_tpu_torch.optimizer.lr",
                "paddle_tpu_torch.nn.clip", "paddle_tpu_torch.amp",
                "paddle_tpu_torch.profiler.metrics", "paddle_tpu_torch.io",
                "paddle_tpu_torch.core.dtype", "paddle_tpu_torch.core.state",
                "paddle_tpu_torch.core.dispatch",
                "paddle_tpu_torch.core.autograd",
                "paddle_tpu_torch.core.tensor", "paddle_tpu_torch.device",
                "paddle_tpu_torch.tensor.random",
                "paddle_tpu_torch.tensor.creation",
                "paddle_tpu_torch.tensor.manipulation",
                "paddle_tpu_torch.tensor.math",
                "paddle_tpu_torch.nn.initializer",
                "paddle_tpu_torch.nn.layer.layers",
                "paddle_tpu_torch.nn.layer.common",
                "paddle_tpu_torch.nn.layer.activation",
                "paddle_tpu_torch.nn.layer.norm",
                "paddle_tpu_torch.nn.layer.transformer",
                "paddle_tpu_torch.nn.functional.common",
                "paddle_tpu_torch.nn.functional.activation",
                "paddle_tpu_torch.nn.functional.norm",
                "paddle_tpu_torch.nn.functional.loss",
                "paddle_tpu_torch.nn.functional.flash_attention",
                "paddle_tpu_torch.nn.functional.init_utils",
                "paddle_tpu_torch.distributed.fleet.recompute",
                "paddle_tpu_torch.models.bert",
                "paddle_tpu_torch.serving.adapters",
                "paddle_tpu_torch.serving.kvcache",
                "paddle_tpu_torch.resilience",
                "paddle_tpu_torch.resilience.faultinject",
                "paddle_tpu_torch.profiler.counters",
                "paddle_tpu_torch.profiler.host_tracer",
                "paddle_tpu_torch.profiler.flight",
                "paddle_tpu_torch.profiler.trace",
                "paddle_tpu_torch.profiler.devicetime",
                "paddle_tpu_torch.profiler.health",
                "paddle_tpu_torch.serving.router",
                "paddle_tpu_torch.serving.autoscale",
                "paddle_tpu_torch.serving.fleet"):
        assert mod in mods, mod
    leaked = [m for m in mods
              if m == "jax" or m.startswith(("jax.", "jaxlib"))
              or m == "paddle_tpu" or m.startswith("paddle_tpu.")]
    assert leaked == []


def _imports(path, package):
    """``(module, relative)`` for every module an import statement
    anywhere in ``path`` names (at module level or inside a function),
    relative imports resolved against ``package``, plus literal
    ``import_module`` / ``__import__`` arguments."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, False
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = package.split(".")
                base = parts[:max(len(parts) - node.level + 1, 0)]
                yield ".".join(base + ([node.module] if node.module
                                       else [])), True
            else:
                yield node.module, False
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value, False


def _escapes(path, package):
    return [mod for mod, relative in _imports(path, package)
            if mod.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")
            or (relative and mod.split(".")[0] != "paddle_tpu_torch")]


def test_no_import_of_jax_or_the_reference_even_lazily(tmp_path):
    """The fleet, router and health plane import the profiler lazily in
    places (as the reference does); every import statement of every
    module of the port, nested ones included, stays inside the port."""
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    import jax.numpy\n"
                     "    from ... import paddle_tpu\n"
                     "    importlib.import_module('paddle_tpu.serving')\n")
    assert len(_escapes(str(probe), "paddle_tpu_torch.serving")) == 3
    root = os.path.join(REPO, "paddle_tpu_torch")
    seen, bad = 0, []
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
            package = (rel[:-len(".__init__")] if rel.endswith("__init__")
                       else rel.rsplit(".", 1)[0])
            seen += 1
            bad += [(rel, m) for m in _escapes(path, package)]
    assert seen > 50 and bad == []


def test_model_without_gpu_raises_instead_of_using_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is cuda")
    from paddle_tpu_torch import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                    num_heads=4, max_seq_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(cfg)


def test_layer_model_without_gpu_raises_instead_of_using_cpu():
    """A paddle-style model lands on the default device: ``cuda`` unless
    ``set_device("cpu")`` was called; without a GPU it raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is cuda")
    from paddle_tpu_torch import device
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    import paddle_tpu_torch as paddle
    prev, device._CURRENT[0] = device._CURRENT[0], None
    try:
        cfg = BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                         num_attention_heads=4, intermediate_size=64,
                         max_position_embeddings=16)
        with pytest.raises(RuntimeError, match="set_device"):
            BertForPretraining(cfg)
        with pytest.raises(RuntimeError, match="set_device"):
            paddle.to_tensor([1.0])
    finally:
        device._CURRENT[0] = prev
