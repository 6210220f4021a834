"""The port's inference facade (paddle_tpu_torch/inference/__init__.py
and serving.ServingPredictor) against paddle_tpu.inference, on the CPU.

A twin of tests/test_serving.py's predictor test: Config.
enable_llm_engine -> create_predictor -> run gives the JAX package's
sequences on the same weights, and the same errors. The artifact
Predictor is not ported (its port is torch.export): it, PredictorPool
and create_predictor without the LLM engine raise NotImplementedError.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.models.generation as jgen
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
    cfg = inference.Config(str(tmp_path))
    assert cfg.model_dir() == str(tmp_path)
    for call in (lambda: inference.create_predictor(cfg),
                 lambda: inference.Predictor(cfg),
                 lambda: inference.PredictorPool(cfg, 2)):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            call()


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
