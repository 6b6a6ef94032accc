"""The port's ViLT serving slice on the CPU: predictor, micro-batcher, HTTP
server and the predict CLI's ``--framework vilt``.

The predictor is held against the JAX package's ViltPredictor built from a
JAX checkpoint file of a tiny ViLT (64 wide, 2 layers, 2 heads of 32,
384x384 images), the weights carried across by ``vilt_state_dict_from_jax``;
tolerance 1e-5 on probabilities and diagnostics (fp32 logits within ~1e-6
through a softmax). The JAX side runs its XLA attention, the port its plain
attention.
"""
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.models.vilt import ViltConfig as JaxConfig
from multimodal_uncertainty_tpu.models.vilt import ViltForImagesAndTextClassification as JaxVilt
from multimodal_uncertainty_tpu.serving import ViltPredictor as JaxPredictor
from multimodal_uncertainty_tpu.training.checkpoint import save_weights as jax_save_weights
from multimodal_uncertainty_tpu_torch.models.jax_import import vilt_state_dict_from_jax
from multimodal_uncertainty_tpu_torch.models.vilt import ViltConfig
from multimodal_uncertainty_tpu_torch.server import (
    PredictionServer,
    uncertainty_result,
    vilt_request,
)
from multimodal_uncertainty_tpu_torch.serving import ViltPredictor, vilt_micro_batcher
from multimodal_uncertainty_tpu_torch.training.checkpoint import save_weights
from multimodal_uncertainty_tpu_torch.zoo import build_vilt

N_CLASSES, IMG = 4, 384
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
            num_labels=N_CLASSES, image_size=IMG)  # the predict CLI's --tiny template


def _batch(seed, n=3, lt=16, mask=None):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, lt + 1, size=n)
    am = (np.arange(lt)[None] < lengths[:, None]).astype(np.int64)
    batch = {"input_ids": rng.integers(104, 30522, size=(n, lt)) * am,
             "attention_mask": am,
             "token_type_ids": np.zeros((n, lt), np.int64),
             "pixel_values": rng.normal(size=(n, IMG, IMG, 3)).astype(np.float32)}
    if mask is not None:
        batch["pixel_mask"] = mask
    return batch


def _rect(h, w):
    m = np.zeros((IMG, IMG), np.int64)
    m[:h, :w] = 1
    return m


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    """(JAX predictor, port predictor) over the same weights."""
    tmp = tmp_path_factory.mktemp("vilt")
    jmodel = JaxVilt(config=dataclasses.replace(JaxConfig.b32(), **TINY), attn_impl="xla")
    sample = {k: jnp.asarray(v) for k, v in _batch(0, n=2).items()}
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init({"params": jax.random.key(0)}, sample, train=False))
    jpath = str(tmp / "jax_vilt_best_val.pt")
    jax_save_weights(variables, None, jpath, async_write=False)
    jpred = JaxPredictor(jmodel, jpath, template_variables=variables, batch_buckets=(4, 8))
    tpath = str(tmp / "model_best_val.pt")
    save_weights(vilt_state_dict_from_jax(variables), None, tpath)
    template = build_vilt(N_CLASSES, vilt_config=dataclasses.replace(ViltConfig.b32(), **TINY),
                          device="cpu", generator=torch.Generator().manual_seed(5))
    tpred = ViltPredictor(template, tpath, batch_buckets=(4, 8), device="cpu")
    return jpred, tpred


@pytest.mark.parametrize("ablate", [None, "image", "text"])
@pytest.mark.parametrize("mask", ["none", "partial"])
def test_predict_matches_jax_predictor(predictors, ablate, mask):
    jpred, tpred = predictors
    pm = None if mask == "none" else np.stack([_rect(IMG, IMG), _rect(256, 320), _rect(0, 0)])
    batch = _batch(1, mask=pm)  # n=3 in bucket 4: one batch-padding row
    got = tpred.predict(batch, ablate=ablate)
    assert got.shape == (3, N_CLASSES)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, jpred.predict(batch, ablate=ablate), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="ablate"):
        tpred.predict(batch, ablate="audio")


def test_predict_with_uncertainty_matches_jax_predictor(predictors):
    jpred, tpred = predictors
    batch = _batch(2, n=5, lt=40)  # bucket 8, the longest text the position table holds
    probs, diag = tpred.predict_with_uncertainty(batch)
    ref_probs, ref_diag = jpred.predict_with_uncertainty(batch)
    np.testing.assert_allclose(probs, ref_probs, atol=1e-5, rtol=0)
    assert set(diag) == {"confidence", "image_sensitivity", "text_sensitivity"}
    for k in diag:
        np.testing.assert_allclose(diag[k], ref_diag[k], atol=1e-5, rtol=0)


def test_nchw_pixels_and_labels_are_taken(predictors):
    _, tpred = predictors
    batch = _batch(3, n=2)
    ref = tpred.predict(batch)
    batch["pixel_values"] = np.ascontiguousarray(batch["pixel_values"].transpose(0, 3, 1, 2))
    batch["labels"] = np.array([1, 2])  # ignored, as by the JAX predictor
    np.testing.assert_allclose(tpred.predict(batch), ref, atol=1e-6, rtol=0)


def _samples(seed, n):
    """Texts of 3-40 tokens; sample 1 a partial pixel mask, sample 2 a zero one."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(3, 41))
        s = {"input_ids": np.concatenate([[101], rng.integers(104, 30522, size=length - 1)]),
             "attention_mask": np.ones(length, np.int64),
             "pixel_values": np.round(rng.normal(size=(IMG, IMG, 3)), 3).astype(np.float32)}
        if i % 3 == 1:
            s["pixel_mask"] = _rect(256, 320)
        elif i % 3 == 2 and i < 3:
            s["pixel_mask"] = np.zeros((IMG, IMG), np.int64)
        out.append(s)
    return out


def _direct(pred, sample):
    """One sample through the predictor alone, its text padded to 8."""
    lt = -(-len(sample["input_ids"]) // 8) * 8
    batch = {}
    for k in ("input_ids", "attention_mask", "token_type_ids"):
        row = np.zeros((1, lt), np.int64)
        if k in sample:
            row[0, :len(sample[k])] = sample[k]
        batch[k] = row
    batch["pixel_values"] = sample["pixel_values"][None]
    if "pixel_mask" in sample:
        batch["pixel_mask"] = sample["pixel_mask"][None]
    return pred.predict_with_uncertainty(batch)


def test_micro_batcher_results_match_direct(predictors):
    """Coalesced predictions equal per-sample ones, of the port and of the
    JAX predictor: a sample without a mask beside one with a mask gets ones."""
    jpred, tpred = predictors
    samples = _samples(4, 5)
    mb = vilt_micro_batcher(tpred, max_batch=4, max_wait_ms=50, uncertainty=True)
    try:
        got = [f.result(timeout=120) for f in [mb.submit(s) for s in samples]]
    finally:
        mb.close()
    for sample, (probs, diag) in zip(samples, got):
        for pred in (tpred, jpred):
            ref, ref_diag = _direct(pred, sample)
            np.testing.assert_allclose(probs, ref[0], atol=1e-5, rtol=0)
            for k in diag:
                np.testing.assert_allclose(diag[k], ref_diag[k][0], atol=1e-5, rtol=0)


def test_micro_batcher_without_uncertainty(predictors):
    _, tpred = predictors
    samples = _samples(5, 2)
    mb = vilt_micro_batcher(tpred, max_batch=4, max_wait_ms=20)
    try:
        got = [f.result(timeout=120) for f in [mb.submit(s) for s in samples]]
    finally:
        mb.close()
    for sample, probs in zip(samples, got):
        np.testing.assert_allclose(probs, _direct(tpred, sample)[0][0], atol=1e-5, rtol=0)


def _post(port, payload, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _body(sample):
    return {k: v.tolist() for k, v in sample.items()}


def _round_trip(srv, samples):
    results = {}

    def call(i):
        results[i] = _post(srv.port, _body(samples[i]))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(samples))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    return results


def test_http_round_trip_with_uncertainty(predictors):
    _, tpred = predictors
    mb = vilt_micro_batcher(tpred, max_batch=4, max_wait_ms=20, uncertainty=True)
    srv = PredictionServer(mb, vilt_request, port=0, encode_result=uncertainty_result).start()
    samples = _samples(6, 3)
    try:
        results = _round_trip(srv, samples)
    finally:
        srv.close()
        mb.close()
    for i, sample in enumerate(samples):
        status, out = results[i]
        assert status == 200
        probs, diag = _direct(tpred, sample)
        np.testing.assert_allclose(out["probs"], probs[0], atol=1e-5)
        for k in diag:
            np.testing.assert_allclose(out[k], diag[k][0], atol=1e-5)


@pytest.mark.parametrize("payload,match", [
    ({"pixel_values": np.zeros((4, 4, 3)).tolist()}, "needs input_ids"),
    ({"input_ids": [1, 2], "pixel_values": np.zeros((4, 4)).tolist()}, "H, W, 3"),
    ({"input_ids": list(range(41)), "pixel_values": np.zeros((4, 4, 3)).tolist()}, "at most 40"),
])
def test_vilt_request_rejects_bad_payloads(payload, match):
    with pytest.raises(ValueError, match=match):
        vilt_request(payload, max_len=40)
    srv = PredictionServer(lambda s: np.zeros(2), lambda p: vilt_request(p, max_len=40)).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, payload)
        assert e.value.code == 400
    finally:
        srv.close()


def _cli_serve(monkeypatch, argv):
    """Run the predict CLI until it would serve forever; return what it built."""
    from multimodal_uncertainty_tpu_torch import predict

    started = {}
    monkeypatch.setattr(predict, "_serve_forever", lambda srv, mb: started.update(srv=srv, mb=mb))
    predict.main(argv)
    return started["srv"], started["mb"]


def test_predict_cli_serves_a_tiny_vilt_checkpoint(tmp_path, monkeypatch):
    """``--framework vilt --tiny`` on the CPU: the CLI's answers equal the
    predictor's on the same checkpoint; a text past 40 tokens is a 400."""
    model = build_vilt(3, vilt_config=dataclasses.replace(ViltConfig.b32(), **{
        **TINY, "num_labels": 3}), device="cpu", generator=torch.Generator().manual_seed(2))
    ckpt = str(tmp_path / "model_best_val.pt")
    save_weights(model, None, ckpt)
    srv, mb = _cli_serve(monkeypatch, [
        "--framework", "vilt", "--serve", "0", "--checkpoint_path", ckpt, "--n_classes", "3",
        "--tiny", "--uncertainty", "--device", "cpu", "--serve_max_batch", "4"])
    samples = _samples(7, 2)
    try:
        results = _round_trip(srv, samples)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, {"input_ids": list(range(41)),
                             "pixel_values": np.zeros((IMG, IMG, 3)).tolist()})
        assert e.value.code == 400
    finally:
        srv.close()
        mb.close()
    pred = ViltPredictor(model, ckpt, batch_buckets=(4,), device="cpu")
    for i, sample in enumerate(samples):
        status, out = results[i]
        assert status == 200 and len(out["probs"]) == 3
        probs, diag = _direct(pred, sample)
        np.testing.assert_allclose(out["probs"], probs[0], atol=1e-6)
        assert set(diag) <= set(out)


@pytest.mark.parametrize("extra,match", [
    (["--framework", "vilt"], "serves only"),
    (["--framework", "vilt", "--serve", "0", "--quantize", "int4"], "quantize"),
])
def test_predict_cli_vilt_errors(extra, match, capsys):
    from multimodal_uncertainty_tpu_torch import predict

    with pytest.raises(SystemExit):
        predict.main(["--checkpoint_path", "unused.pt", "--n_classes", "3", *extra])
    assert match in capsys.readouterr().err


def test_vilt_entry_points_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(ViltConfig.b32(), **TINY)
    ckpt = str(tmp_path / "model_best_val.pt")
    save_weights(build_vilt(N_CLASSES, vilt_config=cfg, device="cpu"), None, ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViltPredictor(build_vilt(N_CLASSES, vilt_config=cfg, device="cpu"), ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_vilt(N_CLASSES, vilt_config=cfg)


def test_full_width_vilt_b32_shapes():
    """ViLT-B/32 with 101 classes, built on the meta device (no memory): the
    configuration the card serves and trains."""
    from multimodal_uncertainty_tpu_torch.models.vilt import ViltForImagesAndTextClassification

    with torch.device("meta"):
        model = ViltForImagesAndTextClassification(
            dataclasses.replace(ViltConfig.b32(), num_labels=101))
    sd = model.state_dict()
    assert len(model.vilt.block) == 12 and model.vilt.block[0].n_head == 12
    assert sd["vilt.word_embeddings"].shape == (30522, 768)
    assert sd["vilt.image_position_embeddings"].shape == (145, 768)
    assert sd["vilt.block.0.qkv.weight"].shape == (2304, 768)
    assert sd["vilt.block.0.fc1.weight"].shape == (3072, 768)
    assert sd["cls_out.weight"].shape == (101, 768)
