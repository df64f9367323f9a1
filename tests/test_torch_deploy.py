"""PyTorch port, decoder artifacts (``mxnet_tpu_torch/deploy.py``) and
``DecoderConfig.to_dict``/``from_dict`` against the JAX package's, on
the CPU (vocab 17, d_model 16, 2 layers, context 32: the reference's
serving fixture).

- an artifact the JAX package exports (f32, int8 and fp8
  ``QuantizedWeights``) loads in the port and serves the JAX engine's
  greedy streams;
- an artifact the port exports loads in the JAX package with the bits
  of the JAX package's own weights (fp8 leaves as the ``|V1`` bytes the
  reference views back) and serves the same streams; f32 and int8
  artifacts are the reference's bytes;
- the config dict round trip, ``flatten_params``' refusals, and a bad
  artifact refused as the reference refuses it
  (``tests/test_llm_serving.py::test_bad_artifact_rejected``);
- the port's new modules import neither JAX nor the JAX package.
"""
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch  # noqa: E402

from mxnet_tpu import deploy as jdeploy  # noqa: E402
from mxnet_tpu.serving import llm as jllm  # noqa: E402
from mxnet_tpu_torch import deploy  # noqa: E402
from mxnet_tpu_torch.resilience import faults  # noqa: E402
from mxnet_tpu_torch.serving import llm as tllm  # noqa: E402

torch.set_num_threads(2)

CFG = dict(vocab_size=17, d_model=16, num_layers=2, num_heads=2, d_ff=32,
           max_context=32)
BS = 8
PROMPTS = ([2, 7, 1], [3, 1, 4, 1, 5, 9, 2, 6, 5], [5] * 12)
NEW = 6
WDTYPES = (None, "int8", "fp8")


def _flat_bits(params):
    """{path: raw bytes} of a param tree (or QuantizedWeights' params and
    scales) from either package."""
    def bits(x):
        if isinstance(x, torch.Tensor):
            return x.contiguous().reshape(-1).view(torch.uint8).numpy() \
                .tobytes()
        return np.ascontiguousarray(np.asarray(x)).tobytes()
    if hasattr(params, "scales"):
        out = {k: bits(v) for k, v in
               deploy.flatten_params(params.params).items()}
        out.update({"scale." + k: bits(v) for k, v in params.scales.items()})
        return out
    return {k: bits(v) for k, v in deploy.flatten_params(params).items()}


def _port_streams(model, params):
    eng = tllm.LLMEngine(model, params, max_seqs=4, block_size=BS,
                         max_context=CFG["max_context"], device="cpu")
    eng.warmup()
    seqs = [tllm.Sequence(p, NEW) for p in PROMPTS]
    for s in seqs:
        eng.add(s)
    while eng.has_work():
        eng.step()
    return [s.output_tokens() for s in seqs]


@pytest.fixture(scope="module")
def world():
    """Per weight dtype: the JAX package's params (numpy or its
    QuantizedWeights), the port's (from the same numpy), both packages'
    artifacts, and the JAX streams: the f32 oracle's, or the JAX
    engine's over the port artifact as the JAX package loads it."""
    jm = jllm.TinyDecoder(jllm.DecoderConfig(**CFG))
    tm = tllm.TinyDecoder(tllm.DecoderConfig(**CFG), device="cpu")
    npp = jm.init_params(seed=0)
    out = {}
    for wd in WDTYPES:
        jp = npp if wd is None else jllm.quantize_weights(npp, dtype=wd)
        tp = npp if wd is None else tllm.quantize_weights(npp, dtype=wd)
        jart = jdeploy.export_decoder(jm, jp)
        tart = deploy.export_decoder(tm, tp)
        jm2, jp2 = jdeploy.load_decoder(tart)
        if wd is None:
            streams = [list(jllm.greedy_decode_reference(jm2, jp2, p, NEW))
                       for p in PROMPTS]
        else:
            eng = jllm.LLMEngine(jm2, jp2, max_seqs=4, block_size=BS,
                                 max_context=CFG["max_context"])
            eng.warmup()
            seqs = [jllm.Sequence(p, NEW) for p in PROMPTS]
            for s in seqs:
                eng.add(s)
            while eng.has_work():
                eng.step()
            streams = [s.output_tokens() for s in seqs]
        out[wd] = dict(jp=jp, tp=tp, jart=jart, tart=tart, jp2=jp2,
                       streams=streams)
    return jm, tm, npp, out


@pytest.mark.parametrize("wd", WDTYPES, ids=["f32", "int8", "fp8"])
def test_jax_artifact_serves_the_jax_streams_in_the_port(world, wd):
    _, _, _, w = world
    model, params = deploy.load_decoder(w[wd]["jart"], device="cpu")
    assert model.config.to_dict() == CFG and model.device.type == "cpu"
    assert _flat_bits(params) == _flat_bits(w[wd]["jp"])
    if wd is not None:
        assert isinstance(params, tllm.QuantizedWeights)
        assert params.dtype == w[wd]["jp"].dtype
        assert params.methods == w[wd]["jp"].methods
    assert _port_streams(model, params) == w[wd]["streams"]


@pytest.mark.parametrize("wd", WDTYPES, ids=["f32", "int8", "fp8"])
def test_port_artifact_serves_in_the_jax_package(world, wd):
    """The JAX package loads the port's artifact to its own weights' bits
    (and, but for fp8's ``<V1``/``|V1`` descr, its own artifact's
    bytes); its engine over them served the fixture's streams, which
    the port's in-memory weights serve too."""
    _, tm, _, w = world
    assert _flat_bits(w[wd]["jp2"]) == _flat_bits(w[wd]["jp"])
    if wd != "fp8":
        assert w[wd]["tart"] == w[wd]["jart"]
    assert _port_streams(tm, w[wd]["tp"]) == w[wd]["streams"]


def test_f32_streams_are_the_oracle(world):
    jm, _, npp, w = world
    assert w[None]["streams"] == [
        list(jllm.greedy_decode_reference(jm, npp, p, NEW))
        for p in PROMPTS]


def test_decoder_config_dict_round_trip():
    t, j = tllm.DecoderConfig(**CFG), jllm.DecoderConfig(**CFG)
    assert t.to_dict() == j.to_dict() == CFG
    assert tuple(tllm.DecoderConfig.FIELDS) == tuple(jllm.DecoderConfig
                                                     .FIELDS)
    back = tllm.DecoderConfig.from_dict(dict(j.to_dict(), extra=1))
    assert repr(back) == repr(t) and back.head_dim == 8
    with pytest.raises(KeyError):
        tllm.DecoderConfig.from_dict({"vocab_size": 3})


def _header(art):
    (h,) = struct.unpack_from("<I", art, 10)
    return json.loads(art[14:14 + h]), art[14 + h:]


def _rewrite(art, **meta):
    head, blob = _header(art)
    head.update(meta)
    raw = json.dumps(head).encode()
    return art[:10] + struct.pack("<I", len(raw)) + raw + blob


@pytest.mark.parametrize("bad", ["magic", "format", "missing"])
def test_bad_artifact_is_refused(world, bad):
    _, _, _, w = world
    art = w[None]["tart"]
    if bad == "magic":
        art = b"NOTANARTIFACT"
    elif bad == "format":
        art = _rewrite(art, format="mxtpu-llm-decoder/other")
    else:
        head, _ = _header(art)
        art = _rewrite(art, arrays=head["arrays"] + ["layers.9.wq"])
    with pytest.raises(ValueError):
        deploy.load_decoder(art, device="cpu")
    with pytest.raises(ValueError):
        jdeploy.load_decoder(art)


def test_flatten_params_refuses_what_cannot_round_trip():
    for tree in ({"a": {}}, {"1": np.zeros(2)}, {"a.b": np.zeros(2)},
                 {"": np.zeros(2)}, []):
        with pytest.raises(ValueError):
            deploy.flatten_params(tree)
        with pytest.raises(ValueError):
            jdeploy.flatten_params(tree)
    tree = {"layers": [{"w": torch.ones(2)}, {"w": torch.zeros(1)}],
            "head": torch.ones(3)}
    flat = deploy.flatten_params(tree)
    assert sorted(flat) == ["head", "layers.0.w", "layers.1.w"]
    back = deploy.unflatten_params(flat)
    assert torch.equal(back["layers"][1]["w"], torch.zeros(1))


def test_export_to_a_path_is_atomic(world, tmp_path):
    _, tm, _, w = world
    path = str(tmp_path / "decoder.mxtpu")
    deploy.export_decoder(tm, w[None]["tp"], path)
    good = open(path, "rb").read()
    faults.kill_write_at("decoder.mxtpu", 100)
    try:
        with pytest.raises(faults.InjectedCrash):
            deploy.export_decoder(tm, w["int8"]["tp"], path)
    finally:
        faults.reset()
    assert open(path, "rb").read() == good
    model, params = deploy.load_decoder(path, device="cpu")
    assert _flat_bits(params) == _flat_bits(w[None]["jp"])


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys; import mxnet_tpu_torch.deploy, "
            "mxnet_tpu_torch.error, mxnet_tpu_torch.base, "
            "mxnet_tpu_torch.resilience, "
            "mxnet_tpu_torch.serving.adapters.registry, "
            "mxnet_tpu_torch.gluon.trainer, mxnet_tpu_torch.recordio, "
            "mxnet_tpu_torch.image, mxnet_tpu_torch.native, "
            "mxnet_tpu_torch.im2rec; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.') or m == 'ml_dtypes']; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    # an artifact round-trips where neither is loaded
    code = ("import sys, numpy as np; "
            "from mxnet_tpu_torch import deploy; "
            "from mxnet_tpu_torch.serving import llm; "
            "m = llm.TinyDecoder(llm.DecoderConfig(), device='cpu'); "
            "q = llm.quantize_weights(m.init_params_numpy(0), dtype='fp8'); "
            "m2, q2 = deploy.load_decoder(deploy.export_decoder(m, q), "
            "device='cpu'); "
            "print(q2.dtype, q2.params['head'].dtype); "
            "sys.exit(0 if 'jax' not in sys.modules else 1)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split() == ["float8_e4m3fn", "torch.float8_e4m3fn"]
