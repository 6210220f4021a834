"""The port's inference facade (paddle_tpu_torch/inference/__init__.py
and serving.ServingPredictor) against paddle_tpu.inference, on the CPU.

A twin of tests/test_serving.py's predictor test: Config.
enable_llm_engine -> create_predictor -> run gives the JAX package's
sequences on the same weights, and the same errors. The artifact
Predictor, PredictorPool and create_predictor without the LLM engine
serve jit.save and static.save_inference_model artifacts: the twins of
tests/test_inference.py run each case on both packages from the same
weights (float32, 1e-5 against the model, 1e-6 between the packages).
The C API case holds the port's Predictor over its own artifact to the
JAX package's C predictor over the JAX artifact of the same program;
the port's capi_so_path raises until native/ is ported.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.models.generation as jgen
import paddle_tpu_torch
from paddle_tpu import inference as jinference
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

from paddle_tpu_torch import inference
from paddle_tpu_torch.inference.serving import ServingPredictor
from paddle_tpu_torch.models.gpt import GPT, GPTConfig

VOCAB = 97
GEOM_KW = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
               max_seq_len=24)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _cpu_device():
    """Bare layers of the artifact twins build on the CPU."""
    from paddle_tpu_torch.core import place
    prev = place._default
    paddle_tpu_torch.set_device("cpu")
    yield
    place._default = prev


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**GEOM_KW))
    jm.eval()
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    return jm, GPT.load_jax_params(GPTConfig(**GEOM_KW), params,
                                   device="cpu")


def _config(pkg, model, **opts):
    cfg = pkg.Config()
    if pkg is inference:
        cfg.disable_gpu()
    cfg.enable_llm_engine(model=model, block_size=4, num_blocks=16,
                          max_num_seqs=4, **opts)
    return cfg


def _inputs():
    rng = np.random.RandomState(0)
    lens = np.asarray([5, 3, 7])
    ids = np.zeros((3, 7), np.int64)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.randint(0, VOCAB, (n,))
    return ids, lens


@pytest.mark.parametrize("opts", [dict(max_tokens=5),
                                  dict(max_tokens=6, decode_chunk_size=2,
                                       prefill_chunk_threshold=4)],
                         ids=["dense", "chunked"])
def test_create_predictor_dispatches_to_serving_engine(models, opts):
    jm, tm = models
    cfg = _config(inference, tm, **opts)
    assert cfg.llm_engine_enabled() and not cfg.use_gpu()
    assert "<llm serving engine>" in cfg.summary()
    pred = inference.create_predictor(cfg)
    assert isinstance(pred, ServingPredictor)
    assert pred.get_input_names() == ["input_ids", "prompt_lens"]
    assert pred.get_output_names() == ["sequences"]
    ids, lens = _inputs()
    [seqs] = pred.run([ids, lens])
    [want] = jinference.create_predictor(_config(jinference, jm,
                                                 **opts)).run([ids, lens])
    assert seqs.dtype == np.int64 and seqs.shape == want.shape
    np.testing.assert_array_equal(seqs, want)
    mt = opts["max_tokens"]
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(seqs[b, :n], ids[b, :n])
        ref = np.asarray(jgen.generate(jm, ids[None, b, :n].astype(np.int32),
                                       mt))[0, n:]
        np.testing.assert_array_equal(seqs[b, n:n + mt], ref)
    # the handle-style surface gives the same output
    pred2 = inference.create_predictor(cfg)
    pred2.get_input_handle("input_ids").copy_from_cpu(ids)
    pred2.get_input_handle("prompt_lens").copy_from_cpu(lens)
    assert pred2.run() is None
    out = pred2.get_output_handle("sequences")
    assert out.shape() == list(seqs.shape) and out.type() == "int64"
    np.testing.assert_array_equal(out.copy_to_cpu(), seqs)


def test_eos_pads_and_no_lens_means_full_rows(models):
    """prompt_lens omitted: every row is a full prompt; eos_token_id
    pads the tail, as in the JAX package."""
    jm, tm = models
    ids, _ = _inputs()
    ids = ids[:, :3]
    ref = np.asarray(jgen.generate(jm, ids[:1].astype(np.int32), 6))[0, 3:]
    eos = int(ref[2])
    got = inference.create_predictor(_config(
        inference, tm, max_tokens=6, eos_token_id=eos)).run([ids])[0]
    want = jinference.create_predictor(_config(
        jinference, jm, max_tokens=6, eos_token_id=eos)).run([ids])[0]
    np.testing.assert_array_equal(got, want)


def test_enable_llm_engine_error_cases(models):
    for pkg in (jinference, inference):
        c2 = pkg.Config()
        c2.enable_llm_engine()               # no model object
        with pytest.raises(ValueError, match="enable_llm_engine"):
            pkg.create_predictor(c2)
        c3 = _config(pkg, models[0] if pkg is jinference else models[1],
                     not_a_field=1)
        with pytest.raises(TypeError):
            pkg.create_predictor(c3)
    with pytest.raises(RuntimeError, match="input_ids"):
        inference.create_predictor(_config(inference, models[1])).run()


def test_artifact_predictor_is_not_ported(tmp_path):
    """The artifact Predictor is ported (the name is kept from when it
    raised): Predictor, PredictorPool and create_predictor over a model
    directory serve a jit.save artifact with the JAX package's outputs,
    and without a model they raise ValueError as the JAX package does."""
    x = np.random.RandomState(4).randn(2, 4).astype(np.float32)
    outs = []
    for pkg, infer in ((paddle, jinference), (paddle_tpu_torch, inference)):
        d = tmp_path / pkg.__name__
        _save_jit_mlp(pkg, str(d / "m"))
        cfg = infer.Config(str(d))
        assert cfg.model_dir() == str(d)
        if infer is inference:
            cfg.disable_gpu()
        got = [infer.create_predictor(cfg).run([x])[0],
               infer.Predictor(cfg).run([x])[0],
               infer.PredictorPool(cfg, 2).retrieve(1).run([x])[0]]
        outs.append(got)
        with pytest.raises(ValueError):
            infer.Predictor(infer.Config())
    for w, g in zip(*outs):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


_MLP_STATE = {}


def _save_jit_mlp(pkg, prefix, spec=(2, 4)):
    """test_inference.py's model (Linear 4-8, ReLU, Linear 8-2) in pkg,
    holding the JAX package's seed-0 weights, saved with jit.save."""
    pkg.seed(0)
    model = pkg.nn.Sequential(pkg.nn.Linear(4, 8), pkg.nn.ReLU(),
                              pkg.nn.Linear(8, 2))
    if not _MLP_STATE:
        assert pkg is paddle
        _MLP_STATE.update({k: np.asarray(v.numpy())
                           for k, v in model.state_dict().items()})
    model.set_state_dict(_MLP_STATE)
    pkg.jit.save(model, prefix,
                 input_spec=[pkg.jit.InputSpec(list(spec), "float32")])
    return model


def _infer(pkg):
    return jinference if pkg is paddle else inference


def _cpu_config(pkg, *args):
    cfg = _infer(pkg).Config(*args)
    if pkg is paddle_tpu_torch:
        cfg.disable_gpu()
    return cfg


def test_predictor_handle_io_matches_model(tmp_path):
    x = np.random.RandomState(5).randn(2, 4).astype("float32")
    outs = []
    for pkg in (paddle, paddle_tpu_torch):
        prefix = str(tmp_path / pkg.__name__)
        model = _save_jit_mlp(pkg, prefix)
        pred = _infer(pkg).create_predictor(_cpu_config(pkg,
                                                        prefix + ".pdmodel"))
        names = pred.get_input_names()
        assert len(names) == 1
        h = pred.get_input_handle(names[0])
        h.copy_from_cpu(x)
        pred.run()
        got = pred.get_output_handle(pred.get_output_names()[0]) \
            .copy_to_cpu()
        want = np.asarray(model(pkg.to_tensor(x)).numpy())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        outs.append(got)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-6)


def test_predictor_list_run_and_pool(tmp_path):
    x = np.random.RandomState(6).randn(2, 4).astype("float32")
    outs = []
    for pkg in (paddle, paddle_tpu_torch):
        d = tmp_path / pkg.__name__
        model = _save_jit_mlp(pkg, str(d / "m"))
        config = _cpu_config(pkg, str(d))  # model_dir form
        got = _infer(pkg).create_predictor(config).run([x])
        np.testing.assert_allclose(
            got[0], np.asarray(model(pkg.to_tensor(x)).numpy()), rtol=1e-5,
            atol=1e-6)
        pool = _infer(pkg).PredictorPool(config, 2)
        np.testing.assert_allclose(pool.retrieve(1).run([x])[0], got[0],
                                   rtol=1e-6)
        outs.append(got[0])
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-6)


def _static_linear_artifact(P, prefix, xv):
    x = P.static.data("x", [3, 4], "float32")
    out = P.p.nn.Linear(4, 2)(x)
    exe = P.exe()
    P.startup(exe)
    P.static.io.save_inference_model(prefix + P.p.__name__, [x], [out],
                                     program=P.static.default_main_program())
    return exe.run(P.static.default_main_program(), feed={"x": xv},
                   fetch_list=[out])[0]


def test_predictor_on_static_artifact(tmp_path):
    """A static.save_inference_model artifact (the port's scope takes the
    JAX scope's weights): the Predictor feeds it by name, with the
    Executor's output, in both packages."""
    from torch_static_twins import run_both
    xv = np.random.RandomState(7).randn(3, 4).astype("float32")
    prefix = str(tmp_path / "static_m_")
    refs = run_both(_static_linear_artifact, prefix, xv)
    outs = []
    for pkg, ref in zip((paddle, paddle_tpu_torch), refs):
        pred = _infer(pkg).create_predictor(
            _cpu_config(pkg, prefix + pkg.__name__ + ".pdmodel"))
        assert pred.get_input_names() == ["x"]
        got = pred.run([xv])[0]
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
        outs.append(got)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-6)


def test_config_knobs_and_errors(tmp_path):
    """test_inference.py's knobs and errors in both packages; the port's
    Predictor runs on CUDA unless the Config asks for the CPU, and an
    artifact exported on the CPU refuses a CUDA Predictor."""
    for pkg in (paddle, paddle_tpu_torch):
        infer = _infer(pkg)
        prefix = str(tmp_path / pkg.__name__)
        _save_jit_mlp(pkg, prefix)
        c = infer.Config(prefix + ".pdmodel")
        c.disable_gpu()
        assert not c.use_gpu()
        c.switch_ir_optim(False)
        assert not c.ir_optim()
        assert "inference config" in c.summary()
        with pytest.raises(NotImplementedError):
            c.enable_tensorrt_engine()
        bad = _cpu_config(pkg, str(tmp_path / "nope"))
        with pytest.raises((ValueError, FileNotFoundError)):
            infer.create_predictor(bad)
        pred = infer.create_predictor(c)
        with pytest.raises(RuntimeError):
            pred.run()  # inputs never set
    gpu = inference.Config(str(tmp_path / "paddle_tpu_torch.pdmodel"))
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="exported on cpu"):
            inference.create_predictor(gpu)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            inference.create_predictor(gpu)
    assert inference.get_version() == paddle_tpu_torch.__version__
    assert jinference.get_version() == paddle.__version__


def _static_matmul_artifact(P, prefix):
    """test_inference.py's C API program: x [4, 3] @ cw + 1.5, cw set in
    the scope."""
    static = P.static
    x = static.data("x", [4, 3], "float32")
    w = static.create_global_var([3, 2], 0.0, "float32", name="cw",
                                 persistable=True)
    out = P.p.matmul(x, w) + 1.5
    exe = P.exe()
    P.startup(exe)
    cw = np.arange(6, dtype=np.float32).reshape(3, 2)
    static.global_scope().set("cw", cw if not P.port
                              else torch.from_numpy(cw))
    static.io.save_inference_model(prefix + P.p.__name__, [x], [out],
                                   program=static.default_main_program())


def test_c_api_predictor_roundtrip(tmp_path):
    """Twin of the C API case: the JAX package's artifact served through
    its C predictor, the port's artifact of the same program through its
    Predictor, with the same output (xv @ cw + 1.5). The port's
    capi_so_path raises until native/ is ported."""
    import ctypes
    from paddle_tpu.native import capi_so_path
    from torch_static_twins import run_both
    prefix = str(tmp_path / "cmodel_")
    run_both(_static_matmul_artifact, prefix)
    xv = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    L = ctypes.CDLL(capi_so_path())
    L.PD_NewPredictor.restype = ctypes.c_void_p
    L.PD_NewPredictor.argtypes = [ctypes.c_char_p]
    L.PD_PredictorRun.restype = ctypes.c_int
    L.PD_PredictorRun.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    L.PD_GetOutput.restype = ctypes.c_int64
    L.PD_GetOutput.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int64]
    L.PD_DeletePredictor.argtypes = [ctypes.c_void_p]
    h = L.PD_NewPredictor((prefix + "paddle_tpu").encode())
    assert h
    n_out = L.PD_PredictorRun(
        h, (ctypes.c_void_p * 1)(xv.ctypes.data),
        (ctypes.c_char_p * 1)(b"float32"), (ctypes.c_int64 * 2)(4, 3),
        (ctypes.c_int * 1)(2), 1)
    assert n_out == 1
    c_out = np.empty((4, 2), np.float32)
    assert L.PD_GetOutput(h, 0, c_out.ctypes.data, c_out.nbytes) == \
        c_out.nbytes
    L.PD_DeletePredictor(h)
    pred = inference.create_predictor(_cpu_config(
        paddle_tpu_torch, prefix + "paddle_tpu_torch.pdmodel"))
    got = pred.run([xv])[0]
    wv = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_allclose(c_out, xv @ wv + 1.5, rtol=1e-5)
    np.testing.assert_allclose(got, c_out, rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="native"):
        inference.capi_so_path()


def test_config_knobs_and_enums_match_jax():
    for pkg in (jinference, inference):
        cfg = pkg.Config("model.pdmodel", "model.pdiparams")
        assert cfg.prog_file() == "model.pdmodel"
        assert cfg.params_file() == "model.pdiparams"
        cfg.set_model("dir")
        assert cfg.model_dir() == "dir"
        cfg.switch_ir_optim(False)
        assert cfg.ir_optim() is False
        cfg.enable_use_gpu(100, 1)
        assert cfg.use_gpu() and cfg.gpu_device_id() == 1
        cfg.disable_gpu()
        assert not cfg.use_gpu()
        for knob in (cfg.enable_memory_optim, cfg.enable_mkldnn,
                     cfg.enable_profile, cfg.disable_glog_info):
            knob()
        cfg.set_cpu_math_library_num_threads(4)
        with pytest.raises(NotImplementedError):
            cfg.enable_tensorrt_engine()
    # the port runs on CUDA unless asked for the CPU
    assert inference.Config().use_gpu()
    for name in ("DataType", "PlaceType", "PrecisionType"):
        jcls, tcls = getattr(jinference, name), getattr(inference, name)
        assert {k: v for k, v in vars(tcls).items()
                if not k.startswith("_")} == \
            {k: v for k, v in vars(jcls).items() if not k.startswith("_")}
    for dt in range(7):
        assert inference.get_num_bytes_of_data_type(dt) == \
            jinference.get_num_bytes_of_data_type(dt)
    with pytest.raises(ValueError):
        inference.get_num_bytes_of_data_type(99)
    t = inference.Tensor("x")
    assert t.name() == "x" and t.shape() == [] and t.type() == "unset"
    t.copy_from_cpu(np.arange(6, dtype=np.int32))
    t.reshape([2, 3])
    assert t.shape() == [2, 3] and t.type() == "int32"
    with pytest.raises(RuntimeError):
        inference.Tensor("y").copy_to_cpu()
