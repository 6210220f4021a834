"""The tiny GPT trained as a static Program, port against the JAX
package, on the CPU: the Program's op types (the 94 the JAX package
records for GPTConfig.tiny() at ids [2, 16] with AdamW.minimize), its
variables and proto bytes, three AdamW steps from the same scope (with
and without ClipGradByGlobalNorm, 1e-5 relative), the static AMP
program (bf16 on both sides, within bf16's reach), the route through
K1 at T 512 (the port's Executor calls K1's forward once per layer a
step: the backward reruns no forward op), and the static step against
the port's own eager GPT (same seed: same startup weights; the first
loss and every gradient bitwise); and chip_smoke.py's phases 41-44
rehearsed at a tiny size.
"""
import collections

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu.static.proto_io import serialize_program_desc as jser
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.ops.kernels import flash_attention as k1
from paddle_tpu_torch.static.proto_io import serialize_program_desc as tser
from torch_static_twins import run_both

# the JAX package's op types for the tiny GPT's program (2 layers, 29
# parameters: one optimize.update each)
JAX_OP_TYPES = {
    "optimize.update": 29, "linear": 13, "getitem": 12, "reshape": 10,
    "elementwise_add": 9, "transpose": 8, "layer_norm": 5,
    "lookup_table_v2": 2, "scaled_dot_product_attention": 2, "gelu": 2,
    "softmax_with_cross_entropy": 1, "backward": 1,
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_global_mesh():
    """The port-only cases build GPTs too: none may pick up a mesh that
    a sharded test left set in the process (run_both clears it for the
    twin cases)."""
    from paddle_tpu_torch.parallel import mesh
    prev = mesh._global_mesh
    mesh.set_global_mesh(None)
    yield
    mesh.set_global_mesh(prev)


def _tiny(T):
    return dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                max_seq_len=max(64, T))


def _k1_tiny(T):
    # one head of 128: the head dim K1 takes (GPTConfig.tiny's 16 is
    # composed attention in both packages)
    return dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=1,
                max_seq_len=T)


def _gpt_program(P, cfg_kw, B, T, clip=False, amp=False, steps=3):
    static = P.static
    gpt = P.p.models.gpt
    cfg = gpt.GPTConfig(**cfg_kw)
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = static.data("ids", [B, T], "int64")
        lab = static.data("lab", [B, T], "int64")
        logits = gpt.GPT(cfg)(ids)
        loss = P.p.nn.functional.cross_entropy(
            logits.reshape([-1, cfg.vocab_size]), lab.reshape([-1, 1]))
        opt = P.p.optimizer.AdamW(
            1e-3, grad_clip=P.p.nn.ClipGradByGlobalNorm(1.0) if clip
            else None)
        if amp:
            opt = static.amp.decorate(opt)
        opt.minimize(loss)
    exe = P.exe()
    P.startup(exe, startup)
    rs = np.random.RandomState(0)
    feed = {"ids": rs.randint(0, cfg.vocab_size, (B, T)).astype(np.int64),
            "lab": rs.randint(0, cfg.vocab_size, (B, T)).astype(np.int64)}
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
              for _ in range(steps)]
    return main, losses


def _structure(P):
    main, losses = _gpt_program(P, _tiny(16), 2, 16)
    return ([od.op_type for od in main.ops],
            [(od.input_names, od.output_names) for od in main.ops],
            [(v.name, list(v.shape)) for v in main.global_block.vars.values()],
            (tser if P.port else jser)(main), losses)


def test_tiny_gpt_program_matches_the_jax_program():
    """Same op types in the same order with the same input and output
    names, the same variables, and proto bytes identical; three AdamW
    steps from the same scope within 1e-5 relative."""
    j, t = run_both(_structure)
    assert collections.Counter(t[0]) == JAX_OP_TYPES
    assert j[0] == t[0] and j[1] == t[1]
    assert [v[0] for v in j[2]] == [v[0] for v in t[2]]
    assert [v[1] for v in j[2]] == [v[1] for v in t[2]]
    assert j[3] == t[3]
    np.testing.assert_allclose(t[4], j[4], rtol=1e-5)
    assert t[4][-1] < t[4][0]


def _clipped(P):
    main, losses = _gpt_program(P, _tiny(16), 2, 16, clip=True)
    return [od.op_type for od in main.ops].count("optimize.clip"), losses


def test_tiny_gpt_with_global_norm_clip():
    j, t = run_both(_clipped)
    assert j[0] == t[0] == 1
    np.testing.assert_allclose(t[1], j[1], rtol=1e-5)


def _amp(P):
    main, losses = _gpt_program(P, _tiny(16), 2, 16, amp=True, steps=4)
    return [od.op_type for od in main.ops], losses


def test_tiny_gpt_static_amp():
    """static.amp.decorate: the op list is the JAX package's, losses are
    finite and fall, and stay within bf16's reach of the JAX package's
    (both compute the white-listed ops in bf16 on the CPU; they round
    differently: 2e-2 relative)."""
    j, t = run_both(_amp)
    assert j[0] == t[0]
    assert np.isfinite(t[1]).all() and t[1][-1] < t[1][0]
    np.testing.assert_allclose(t[1], j[1], rtol=2e-2)


def _k1_route(P, counter):
    before = counter[0]
    _, losses = _gpt_program(P, _k1_tiny(512), 1, 512, steps=2)
    return losses, counter[0] - before


def test_t512_routes_through_k1_once_per_layer(monkeypatch):
    """At T 512 (flash_attention_min_seq) the port's attention goes to
    K1's wrapper (its CPU twin here; the JAX side stays composed off
    the TPU): two steps call K1's forward 2 x num_layers times, since the
    Executor's backward is autograd over the forward it ran, and the
    losses match the JAX package's."""
    counter = [0]
    ref = k1.flash_attention_reference

    def counted(*a, **k):
        counter[0] += 1
        return ref(*a, **k)

    monkeypatch.setattr(k1, "flash_attention_reference", counted)
    j, t = run_both(_k1_route, counter)
    assert t[1] == 2 * _k1_tiny(512)["num_layers"]
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5)


def test_static_step_equals_the_eager_step():
    """The same seed gives the static GPT's startup the eager GPT's
    weights; one static step's loss and every parameter gradient equal
    the eager forward and backward bitwise (the same ops in the same
    order)."""
    from paddle_tpu_torch import static
    cfg = GPTConfig(**_tiny(16))
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 256, (2, 16)).astype(np.int64)
    lab = rs.randint(0, 256, (2, 16)).astype(np.int64)
    eager = GPT(cfg, device="cpu", seed=3)
    loss_e = eager.loss(torch.from_numpy(ids), torch.from_numpy(lab))
    loss_e.backward()
    main, startup = static.Program(), static.Program()
    paddle_tpu_torch.enable_static()
    try:
        with static.program_guard(main, startup):
            x = static.data("ids", [2, 16], "int64")
            y = static.data("lab", [2, 16], "int64")
            model = GPT(cfg, seed=3)
            loss = paddle_tpu_torch.nn.functional.cross_entropy(
                model(x).reshape([-1, 256]), y.reshape([-1, 1]))
            pg = static.append_backward(loss)
    finally:
        paddle_tpu_torch.disable_static()
    scope = static.Scope()
    exe = static.Executor(paddle_tpu_torch.CPUPlace())
    exe.run(startup, scope=scope)
    names = {p.name: n for n, p in model.named_parameters()}
    eager_p = dict(eager.named_parameters())
    for pname, sname in names.items():
        assert torch.equal(scope.find_var(pname), eager_p[sname].detach())
    outs = exe.run(main, feed={"ids": ids, "lab": lab},
                   fetch_list=[loss] + [g for _, g in pg], scope=scope)
    assert outs[0] == loss_e.detach().numpy()
    for (p, _), g in zip(pg, outs[1:]):
        np.testing.assert_array_equal(
            g, eager_p[names[p.name]].grad.numpy(), err_msg=p.name)


def test_chip_smoke_static_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's phases 41-44 at a tiny size on the CPU (K1's plain
    version at T 128 stands in for the kernel, so only the launch gates,
    which need the card, are left out): every other gate holds, phase
    43's artifact through the Predictor (phase 47's part) included."""
    import chip_smoke as cs
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.tools import train_bench
    failed = []
    monkeypatch.setattr(cs, "_require", lambda ok, what: ok or failed.append(
        what))
    monkeypatch.setattr(train_bench, "bench_config", lambda h=6: GPTConfig(
        vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
        max_seq_len=128))
    monkeypatch.setattr(train_bench, "BATCH", 4)
    monkeypatch.setattr(train_bench, "SEQ", 128)
    monkeypatch.setattr(cs, "STATIC_CHECK_B", 2)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(paddle_tpu_torch, "CUDAPlace",
                        lambda i=0: paddle_tpu_torch.CPUPlace())
    prev = flags.flag("flash_attention_min_seq")
    flags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    try:
        out = cs.run_static(torch.device("cpu"), 0, {
            "tokens_per_sec": 1.0, "step_s": [1.0], "peak_mem_gb": 0.0,
            "idle_share": 0.0}, cs.Laps())
    finally:
        flags.set_flags({"FLAGS_flash_attention_min_seq": prev})
    assert out == {"static_launches": [0, 0], "artifact_launches": [0, 0],
                   "predictor_launches": [0, 0]}
    assert failed and all("launched" in f for f in failed), failed
