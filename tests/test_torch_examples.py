"""The examples' single-chip surface on the port, on the CPU.

Every `paddle.*` attribute chain (and every `from paddle_tpu.X import
...` name) that the single-chip path of examples/gpt_pretrain.py,
examples/bert_pretrain.py, examples/resnet_train.py and
examples/mnist_lenet.py reaches must resolve on paddle_tpu_torch; the
multi-chip branches (`if args.dp ...`) wait for the distributed slice.
Then gpt_pretrain.py's, mnist_lenet.py's and gpt_generate.py's own
bodies run on the port with `import paddle_tpu as paddle` read as
`import paddle_tpu_torch as paddle` (gpt_pretrain's JAX platform lines
dropped), on the CPU at a small size.
"""
import ast
import importlib
import io
import math
import re
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.core import place as _place

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SINGLE_CHIP = ("gpt_pretrain.py", "bert_pretrain.py", "resnet_train.py",
               "mnist_lenet.py")


def _multi_chip(node) -> bool:
    """An `if` whose test reads args.dp / args.tp / args.sharding."""
    return isinstance(node, ast.If) and any(
        isinstance(n, ast.Attribute) and n.attr in ("dp", "tp", "sharding")
        for n in ast.walk(node.test))


def _single_chip_nodes(tree):
    """Every node outside the bodies of the multi-chip branches (their
    else branches are the single-chip path and stay)."""
    skip = set()
    for node in ast.walk(tree):
        if _multi_chip(node):
            for stmt in node.body:
                skip.update(id(n) for n in ast.walk(stmt))
    return [n for n in ast.walk(tree) if id(n) not in skip]


def _surface(path):
    """(attribute chains as port module paths, (module, name) imports)
    of an example's single-chip path."""
    tree = ast.parse(path.read_text())
    nodes = _single_chip_nodes(tree)
    alias = {}
    imports = set()
    for n in nodes:
        if isinstance(n, ast.Import):
            for a in n.names:
                if a.name.startswith("paddle_tpu"):
                    alias[a.asname or a.name] = a.name
        elif isinstance(n, ast.ImportFrom) and n.module and \
                n.module.startswith("paddle_tpu"):
            for a in n.names:
                imports.add((n.module, a.name))
                alias[a.asname or a.name] = f"{n.module}.{a.name}"
    chains = set()
    for n in nodes:
        if isinstance(n, ast.Attribute):
            parts = []
            cur = n
            while isinstance(cur, ast.Attribute):
                parts.append(cur.attr)
                cur = cur.value
            if isinstance(cur, ast.Name) and cur.id in alias:
                chains.add(".".join([alias[cur.id]] + parts[::-1]))
    return chains, imports


def _resolve(dotted: str):
    parts = dotted.replace("paddle_tpu", "paddle_tpu_torch", 1).split(".")
    obj = importlib.import_module(parts[0])
    for i, p in enumerate(parts[1:], 1):
        if not hasattr(obj, p):
            obj = importlib.import_module(".".join(parts[:i + 1]))
        else:
            obj = getattr(obj, p)
    return obj


@pytest.mark.parametrize("example", SINGLE_CHIP)
def test_single_chip_surface_resolves_on_the_port(example):
    chains, imports = _surface(EXAMPLES / example)
    assert chains, example
    missing = []
    for chain in sorted(chains):
        try:
            _resolve(chain)
        except (AttributeError, ModuleNotFoundError):
            missing.append(chain)
    for module, name in sorted(imports):
        try:
            getattr(_resolve(module), name)
        except (AttributeError, ModuleNotFoundError):
            missing.append(f"{module}.{name}")
    assert not missing, missing


def test_gpt_pretrain_body_runs_on_the_port(monkeypatch):
    src = (EXAMPLES / "gpt_pretrain.py").read_text()
    src = src.replace("import paddle_tpu as paddle",
                      "import paddle_tpu_torch as paddle")
    src = src.replace("from paddle_tpu.models.gpt",
                      "from paddle_tpu_torch.models.gpt")
    src = src.replace("import jax\n", "")
    src = re.sub(r'if os\.environ\.get\("JAX_PLATFORMS"\) == "cpu":\n'
                 r'(    #.*\n)*    jax\.config\.update\([^\n]*\)\n', "", src)
    assert "jax" not in src.replace("JAX_PLATFORMS", "")
    assert "paddle_tpu_torch as paddle" in src
    ns = {"__name__": "gpt_pretrain_on_port",
          "__file__": str(EXAMPLES / "gpt_pretrain.py")}
    exec(compile(src, "gpt_pretrain.py", "exec"), ns)
    monkeypatch.setattr("sys.argv", ["gpt_pretrain.py", "--steps", "3",
                                     "--batch-size", "2", "--seq", "32"])
    prev = _place._default
    paddle_tpu_torch.set_device("cpu")
    out = io.StringIO()
    try:
        with redirect_stdout(out):
            ns["main"]()
    finally:
        _place._default = prev
    losses = [float(m) for m in re.findall(r"loss ([-\d.]+)",
                                           out.getvalue())]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses), \
        out.getvalue()


def test_mnist_lenet_body_runs_on_the_port(monkeypatch):
    """examples/mnist_lenet.py on the port: synthetic MNIST through the
    DataLoader and DeviceLoader into a LeNet TrainStep, one epoch at the
    example's batch of 64 over the first 8 batches of the train set,
    then its evaluation over the test set."""
    import paddle_tpu_torch.vision.datasets.mnist as mnist
    src = (EXAMPLES / "mnist_lenet.py").read_text()
    src = src.replace("import paddle_tpu as paddle",
                      "import paddle_tpu_torch as paddle")
    assert "paddle_tpu_torch as paddle" in src and "jax" not in src
    ns = {"__name__": "mnist_lenet_on_port",
          "__file__": str(EXAMPLES / "mnist_lenet.py")}
    exec(compile(src, "mnist_lenet.py", "exec"), ns)
    real = mnist._synthetic_digits
    monkeypatch.setattr(mnist, "_synthetic_digits",
                        lambda n, seed, **kw: real(min(n, 512), seed, **kw))
    monkeypatch.setattr("sys.argv", ["mnist_lenet.py", "--epochs", "1"])
    prev, threads = _place._default, torch.get_num_threads()
    paddle_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)
    out = io.StringIO()
    try:
        with redirect_stdout(out):
            ns["main"]()
    finally:
        _place._default = prev
        torch.set_num_threads(threads)
    text = out.getvalue()
    loss = [float(m) for m in re.findall(r"loss ([-\d.]+)", text)]
    acc = [float(m) for m in re.findall(r"test accuracy: ([\d.]+)", text)]
    assert len(loss) == 1 and math.isfinite(loss[0]), text
    assert len(acc) == 1 and 0.0 <= acc[0] <= 1.0, text


def test_gpt_generate_body_runs_on_the_port():
    """examples/gpt_generate.py on the port at the example's own sizes:
    400 TrainStep steps teach the tiny GPT (t + 1) % 128, then greedy,
    sampled and beam decoding, and export_decoder served by
    DecoderPredictor without the model class; the greedy and served
    tokens continue the prompt's count."""
    src = (EXAMPLES / "gpt_generate.py").read_text()
    src = src.replace("import paddle_tpu as paddle",
                      "import paddle_tpu_torch as paddle")
    src = src.replace("import paddle_tpu.optimizer as opt",
                      "import paddle_tpu_torch.optimizer as opt")
    src = src.replace("from paddle_tpu.models.", "from paddle_tpu_torch.models.")
    assert "paddle_tpu." not in src.replace("paddle_tpu_torch", "")
    assert "jax" not in src
    ns = {"__name__": "gpt_generate_on_port",
          "__file__": str(EXAMPLES / "gpt_generate.py")}
    exec(compile(src, "gpt_generate.py", "exec"), ns)
    prev, threads = _place._default, torch.get_num_threads()
    paddle_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)
    out = io.StringIO()
    try:
        with redirect_stdout(out):
            ns["main"]()
    finally:
        _place._default = prev
        torch.set_num_threads(threads)
    text = out.getvalue()
    loss = float(re.search(r"final train loss: ([-\d.]+)", text).group(1))
    greedy = eval(re.search(r"greedy: +(\[[^\]]*\])", text).group(1))
    served = eval(re.search(r"served: +(\[[^\]]*\])", text).group(1))
    assert loss < 0.5, text
    assert greedy == [10, 11, 12, 13, 14, 15], text
    assert served == [16, 17, 18, 19], text
    assert "beam-4:" in text and "sampled:" in text
