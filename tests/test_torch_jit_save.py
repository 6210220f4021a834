"""jit.save / load / TranslatedLayer / TracedLayer, export_decoder /
DecoderPredictor and the K2 capture, port against the JAX package, on
the CPU.

- The repair of ROADMAP Queue 3 item 13: a GPT whose heads route to K2
  (head dim 64, an even head count, T 512) is captured as a static
  Program (K2's custom ops have fake versions) and trained by the
  Executor in both packages from the same scope: logits within 1e-5,
  three SGD losses within 1e-5 relative (float32).
- jit.save with a [None, n] spec: one artifact serves two batch sizes
  with the eager outputs, in both packages from the same weights (an
  MLP, 1e-6); the port's GPT artifact does too, where the JAX GPT pins
  its batch to 1 (1e-5 at batch 1);
  a dim the model fixes takes the pinned-shape fallback with the JAX
  code's warning; a missing spec raises ValueError; the layer comes
  back in its mode; a to_static Layer saves its raw forward.
- TracedLayer: trace returns (outputs, traced); save_inference_model
  warns on feed / fetch and writes a jit.save artifact.
- test_generation.py's test_exported_decoder_serves_without_model on
  both packages from the JAX model's weights: the served tokens equal
  generate() and the JAX package's served tokens.
- chip_smoke.py's phases 45-48 at a tiny size (the plain versions stand
  in for K1 and K2, so only the launch gates, which need the card, are
  left out).
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.models.generation as jgen
import paddle_tpu_torch
import paddle_tpu_torch.models.generation as gen
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from torch_static_twins import run_both

PKGS = (paddle_tpu, paddle_tpu_torch)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _cpu_no_mesh():
    from paddle_tpu.parallel import mesh as jmesh
    from paddle_tpu_torch.parallel import mesh as tmesh
    prev = _place._default, jmesh.get_global_mesh(), tmesh._global_mesh
    jmesh.set_global_mesh(None)
    tmesh.set_global_mesh(None)
    paddle_tpu_torch.set_device("cpu")
    yield
    _place._default = prev[0]
    jmesh.set_global_mesh(prev[1])
    tmesh.set_global_mesh(prev[2])


# --------------------------------------------------- Queue 3 item 13: K2
K2_GPT = dict(vocab_size=64, hidden_size=128, num_layers=1, num_heads=2,
              max_seq_len=512)


def _k2_static_gpt(P):
    static = P.static
    gpt = P.p.models.gpt
    cfg = gpt.GPTConfig(**K2_GPT)
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = static.data("ids", [1, 512], "int64")
        lab = static.data("lab", [1, 512], "int64")
        logits = gpt.GPT(cfg)(ids)
        loss = P.p.nn.functional.cross_entropy(
            logits.reshape([-1, 64]), lab.reshape([-1, 1]))
        P.p.optimizer.SGD(0.1).minimize(loss)
    exe = P.exe()
    P.startup(exe, startup)
    rs = np.random.RandomState(0)
    feed = {n: rs.randint(0, 64, (1, 512)).astype(np.int64)
            for n in ("ids", "lab")}
    (lg,) = exe.run(main.clone(for_test=True), feed=feed,
                    fetch_list=[logits])
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
              for _ in range(3)]
    return np.asarray(lg), losses


def test_head_dim_64_gpt_captures_and_trains_as_a_static_program(
        monkeypatch):
    """The port routes the heads to K2 (its plain version on the CPU,
    called once in the captured forward's shape inference and once a
    replay), the JAX package to composed attention; both programs give
    the same logits and SGD losses."""
    from paddle_tpu_torch.ops.kernels import packed_flash
    calls = []
    real = packed_flash.packed_flash_attention
    monkeypatch.setattr(packed_flash, "packed_flash_attention",
                        lambda *a: calls.append(a[0].device.type) or real(*a))
    j, t = run_both(_k2_static_gpt)
    assert calls[0] == "meta" and set(calls[1:]) == {"cpu"}
    assert j[0].shape == t[0].shape == (1, 512, 64)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-5)
    assert t[1][-1] < t[1][0]


# ------------------------------------------------------------- jit.save
TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=24)


def _gpt_pair(**kw):
    """The JAX tiny GPT and the port's GPT holding its weights."""
    paddle_tpu.seed(0)
    cfg = dict(TINY, **kw)
    jm = JGPT(JGPTConfig(**cfg))
    jm.eval()
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    tm = GPT.load_jax_params(GPTConfig(**cfg), params, device="cpu")
    tm.eval()
    return jm, tm


def test_jit_save_serves_two_batch_sizes_in_both_packages(tmp_path):
    """An MLP artifact with a [None, 4] spec serves batch 1 and 3 with
    the eager outputs in both packages, which agree (1e-6)."""
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    served, state = [], {}
    for pkg in PKGS:
        pkg.seed(0)
        model = pkg.nn.Sequential(pkg.nn.Linear(4, 8), pkg.nn.ReLU(),
                                  pkg.nn.Linear(8, 2))
        if state:
            model.set_state_dict(state)
        state = {k: np.asarray(v.numpy())
                 for k, v in model.state_dict().items()}
        prefix = str(tmp_path / pkg.__name__)
        pkg.jit.save(model, prefix,
                     input_spec=[pkg.jit.InputSpec([None, 4], "float32")])
        layer = pkg.jit.load(prefix)
        outs = []
        for b in (1, 3):
            want = np.asarray(model(pkg.to_tensor(x[:b])).numpy())
            got = np.asarray(layer(pkg.to_tensor(x[:b])).numpy())
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            outs.append(got)
        served.append(outs)
    for w, g in zip(*served):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_gpt_artifact_serves_two_batch_sizes(tmp_path):
    """The port's GPT artifact ([None, 16] ids) serves batch 1 and 3 with
    the eager logits from one export. The JAX package's GPT fails its
    symbolic export (its reshapes read the batch), warns and pins the
    batch to 1; at batch 1 the two artifacts agree (1e-5)."""
    jm, tm = _gpt_pair()
    ids = np.random.RandomState(0).randint(0, 97, (3, 16))
    prefix = str(tmp_path / "port")
    paddle_tpu_torch.jit.save(tm, prefix, input_spec=[
        paddle_tpu_torch.jit.InputSpec([None, 16], "int64")])
    layer = paddle_tpu_torch.jit.load(prefix)
    for b in (1, 3):
        x = paddle_tpu_torch.to_tensor(ids[:b])
        np.testing.assert_allclose(layer(x).numpy(), tm(x).numpy(),
                                   rtol=1e-6, atol=1e-6)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        paddle_tpu.jit.save(jm, str(tmp_path / "jax"), input_spec=[
            paddle_tpu.jit.InputSpec([None, 16], "int64")])
    assert any("pinned to 1" in str(m.message) for m in w)
    jax_out = paddle_tpu.jit.load(str(tmp_path / "jax"))(
        paddle_tpu.to_tensor(ids[:1])).numpy()
    np.testing.assert_allclose(
        layer(paddle_tpu_torch.to_tensor(ids[:1])).numpy(),
        np.asarray(jax_out), rtol=1e-5, atol=1e-5)


def _fixed_batch_layer(pkg):
    class FixedBatch(pkg.nn.Layer):
        """Adds a [2, 4] buffer: the batch must be 2 or 1."""

        def __init__(self):
            super().__init__()
            self.register_buffer("c", pkg.to_tensor(
                np.arange(8, dtype=np.float32).reshape(2, 4)))

        def forward(self, x):
            return x + self.c
    return FixedBatch()


def test_pinned_shape_fallback_warns_in_both_packages(tmp_path):
    """A model that fixes the dynamic batch fails the symbolic export;
    both packages re-export with it pinned to 1, warn, and serve that
    batch."""
    x = np.ones((1, 4), np.float32)
    out = []
    for pkg in PKGS:
        layer = _fixed_batch_layer(pkg)
        prefix = str(tmp_path / pkg.__name__)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            pkg.jit.save(layer, prefix,
                         input_spec=[pkg.jit.InputSpec([None, 4])])
        assert any("pinned to 1" in str(m.message) for m in w), pkg
        out.append(np.asarray(pkg.jit.load(prefix)(pkg.to_tensor(x))
                              .numpy()))
    np.testing.assert_array_equal(out[1], out[0])
    assert out[1].shape == (2, 4)


def test_jit_save_errors_modes_and_to_static(tmp_path):
    """A missing input_spec raises ValueError in both packages; the
    layer is exported in eval() and returned in train(); a to_static
    Layer saves its raw forward and keeps its StaticFunction."""
    for pkg in PKGS:
        lin = pkg.nn.Linear(4, 2)
        with pytest.raises(ValueError):
            pkg.jit.save(lin, str(tmp_path / "nope"))
    paddle_tpu_torch.seed(0)
    net = paddle_tpu_torch.nn.Sequential(paddle_tpu_torch.nn.Linear(4, 4),
                                         paddle_tpu_torch.nn.Dropout(0.5))
    net = paddle_tpu_torch.jit.to_static(net)
    static_fn = net.forward
    net.train()
    prefix = str(tmp_path / "drop")
    paddle_tpu_torch.jit.save(net, prefix, input_spec=[
        paddle_tpu_torch.jit.InputSpec([None, 4])])
    assert net.training and net.forward is static_fn
    x = paddle_tpu_torch.to_tensor(np.ones((3, 4), np.float32))
    net.eval()
    np.testing.assert_array_equal(
        paddle_tpu_torch.jit.load(prefix)(x).numpy(), net(x).numpy())


def test_traced_layer_in_both_packages(tmp_path):
    """TracedLayer.trace returns (outputs, traced); the traced object
    calls the layer; save_inference_model warns when feed / fetch are
    given and writes an artifact that jit.load serves."""
    x = np.random.RandomState(3).randn(2, 4).astype(np.float32)
    loaded = []
    for pkg in PKGS:
        pkg.seed(0)
        lin = pkg.nn.Linear(4, 3)
        if pkg is paddle_tpu_torch:
            lin.set_state_dict(state)
        state = {k: np.asarray(v.numpy()) for k, v in
                 lin.state_dict().items()}
        out, traced = pkg.jit.TracedLayer.trace(lin, [pkg.to_tensor(x)])
        np.testing.assert_array_equal(
            np.asarray(traced(pkg.to_tensor(x)).numpy()),
            np.asarray(out.numpy()))
        prefix = str(tmp_path / pkg.__name__)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            traced.save_inference_model(prefix, feed=[0], fetch=[0])
        assert any("feed/fetch" in str(m.message) for m in w)
        loaded.append(np.asarray(pkg.jit.load(prefix)(pkg.to_tensor(x))
                                 .numpy()))
    np.testing.assert_allclose(loaded[1], loaded[0], rtol=1e-6)


# --------------------------------------------------------- export_decoder
def test_exported_decoder_serves_without_model(tmp_path):
    """Twin of tests/test_generation.py's case: both packages export the
    same weights; each DecoderPredictor's tokens equal its generate() and
    the other package's, and a prompt off the exported length raises."""
    jm, tm = _gpt_pair()
    served = []
    for pkg, module, m in ((paddle_tpu, jgen, jm), (paddle_tpu_torch, gen,
                                                    tm)):
        prefix = str(tmp_path / pkg.__name__)
        module.export_decoder(m, prefix)
        pred = module.DecoderPredictor(prefix)
        Tp = pred.prefill_len
        ids = np.random.RandomState(6).randint(1, 97, (2, Tp))
        out = pred.generate(ids, max_new_tokens=5)
        np.testing.assert_array_equal(out, module.generate(m, ids, 5))
        with pytest.raises(ValueError):
            pred.generate(np.zeros((1, Tp + 1), np.int64), 2)
        with pytest.raises(ValueError):
            pred.generate(np.zeros((1, Tp), np.int64), 24)
        served.append(out)
    np.testing.assert_array_equal(served[1], served[0])


# ----------------------------------------------- chip_smoke phases 45-48
def test_chip_smoke_slice_10b_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's phases 45-48 at a tiny size on the CPU: every gate
    holds but the launch counts, which need the card."""
    import chip_smoke as cs
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.tools import engine_bench, train_bench
    failed = []
    monkeypatch.setattr(cs, "_require", lambda ok, what: ok or failed.append(
        what))
    monkeypatch.setattr(train_bench, "bench_config", lambda h=6: GPTConfig(
        vocab_size=256, hidden_size=128 if h == 12 else 256, num_layers=2,
        num_heads=2, max_seq_len=128))
    monkeypatch.setattr(engine_bench, "GPT_CONFIG", TINY)
    monkeypatch.setattr(cs, "STATIC_CHECK_B", 2)
    monkeypatch.setattr(cs, "TO_STATIC", dict(batch=2, steps=2, lr=1e-3))
    monkeypatch.setattr(cs, "DECODER", dict(prompts=2, new=4))
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(paddle_tpu_torch, "CUDAPlace",
                        lambda i=0: paddle_tpu_torch.CPUPlace())
    prev = flags.flag("flash_attention_min_seq")
    flags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    try:
        out = cs.run_slice_10b(torch.device("cpu"), 0, cs.Laps())
    finally:
        flags.set_flags({"FLAGS_flash_attention_min_seq": prev})
    assert out == {"k2_static": [0, 0], "to_static": [0, 0],
                   "k1_jit_save": [0, 0], "k2_jit_save": [0, 0],
                   "k1_predictor": [0, 0], "k2_predictor": [0, 0]}
    assert failed and all("launched" in f for f in failed), failed
