"""The port's MMBT serving slice on the CPU: predictor, micro-batcher, HTTP
server, checkpoints and the predict CLI's ``--framework mmbt``.

The predictor is held against the JAX package's MMBTPredictor built from a
JAX checkpoint file (random BatchNorm statistics included), with the weights
carried across by ``mmbt_state_dict_from_jax``; tolerance 1e-5 on
probabilities (fp32 logits within ~1e-6 through a softmax).
"""
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.models import bert as JB
from multimodal_uncertainty_tpu.models.mmbt import MultimodalBertClf as JaxMMBT
from multimodal_uncertainty_tpu.serving import MMBTPredictor as JaxPredictor
from multimodal_uncertainty_tpu.training.checkpoint import save_weights as jax_save_weights
from multimodal_uncertainty_tpu_torch.models import bert as TB
from multimodal_uncertainty_tpu_torch.models.jax_import import mmbt_state_dict_from_jax
from multimodal_uncertainty_tpu_torch.models.mmbt import MultimodalBertClf
from multimodal_uncertainty_tpu_torch.server import (
    PredictionServer,
    mmbt_request,
    uncertainty_result,
)
from multimodal_uncertainty_tpu_torch.serving import MMBTPredictor, mmbt_micro_batcher
from multimodal_uncertainty_tpu_torch.training.checkpoint import (
    load_weights,
    restore_into,
    save_weights,
)

BERT = dict(vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=256, max_position_embeddings=128)
N_CLASSES, RESNET, IMG = 4, (1, 1, 1, 1), 64


def _template():
    return MultimodalBertClf(TB.BertConfig(**BERT), N_CLASSES, resnet_layers=RESNET,
                             generator=torch.Generator().manual_seed(5))


def _batch(seed, n=3, lt=24):
    """Ragged texts of 6-``lt`` tokens, random token types, float images."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(6, lt + 1, size=n)
    mask = (np.arange(lt)[None] < lengths[:, None]).astype(np.int64)
    txt = rng.integers(0, BERT["vocab_size"], size=(n, lt)) * mask
    seg = rng.integers(0, 2, size=(n, lt)) * mask
    img = rng.normal(size=(n, IMG, IMG, 3)).astype(np.float32)
    return txt, mask, seg, img


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    """(JAX predictor, port predictor) over the same weights and statistics."""
    tmp = tmp_path_factory.mktemp("mmbt")
    jmodel = JaxMMBT(config=JB.BertConfig(**BERT), n_classes=N_CLASSES, num_image_embeds=3,
                     resnet_layers=RESNET, attn_impl="xla")
    x = tuple(jnp.asarray(a) for a in _batch(0, n=2))
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init({"params": jax.random.key(0)}, x, train=False))
    rng = np.random.default_rng(1)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"])
    jpath = str(tmp / "jax_mmbt_best_val.pt")
    jax_save_weights(variables, None, jpath, async_write=False)
    jpred = JaxPredictor(jmodel, jpath, template_variables=variables, batch_buckets=(4, 8))

    tpath = str(tmp / "model_best_val.pt")
    save_weights(mmbt_state_dict_from_jax(variables), None, tpath)
    tpred = MMBTPredictor(_template(), tpath, batch_buckets=(4, 8), device="cpu")
    return jpred, tpred


@pytest.mark.parametrize("ablate", [None, "image", "text"])
def test_predict_matches_jax_predictor(predictors, ablate):
    jpred, tpred = predictors
    batch = _batch(1)  # n=3 in bucket 4: one batch-padding row
    got = tpred.predict(*batch, ablate=ablate)
    assert got.shape == (3, N_CLASSES)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, jpred.predict(*batch, ablate=ablate), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="ablate"):
        tpred.predict(*batch, ablate="audio")


def test_predict_with_uncertainty_matches_jax_predictor(predictors):
    jpred, tpred = predictors
    batch = _batch(2, n=5)  # bucket 8
    probs, diag = tpred.predict_with_uncertainty(*batch)
    ref_probs, ref_diag = jpred.predict_with_uncertainty(*batch)
    np.testing.assert_allclose(probs, ref_probs, atol=1e-5, rtol=0)
    assert set(diag) == {"confidence", "image_sensitivity", "text_sensitivity"}
    for k in diag:
        np.testing.assert_allclose(diag[k], ref_diag[k], atol=1e-5, rtol=0)


def test_uint8_images_are_cast_not_normalised(predictors):
    _, tpred = predictors
    txt, mask, seg, img = _batch(3, n=2)
    pixels = np.random.default_rng(3).integers(0, 256, size=img.shape).astype(np.uint8)
    np.testing.assert_allclose(tpred.predict(txt, mask, seg, pixels),
                               tpred.predict(txt, mask, seg, pixels.astype(np.float32)),
                               atol=0, rtol=0)


def _samples(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(6, 41))
        out.append((rng.integers(0, BERT["vocab_size"], size=length),
                    rng.integers(0, 2, size=length),
                    rng.normal(size=(IMG, IMG, 3)).astype(np.float32)))
    return out


def _direct(pred, sample):
    """One sample through the predictor alone, its text padded to 32."""
    ids, seg, img = sample
    lt = -(-len(ids) // 32) * 32
    txt, segment, mask = (np.zeros((1, lt), np.int64) for _ in range(3))
    txt[0, :len(ids)], segment[0, :len(ids)], mask[0, :len(ids)] = ids, seg, 1
    return pred.predict_with_uncertainty(txt, mask, segment, img[None])


def test_micro_batcher_results_match_direct(predictors):
    """Coalesced predictions equal per-sample ones, of the port and of the
    JAX predictor."""
    jpred, tpred = predictors
    samples = _samples(4, 7)
    mb = mmbt_micro_batcher(tpred, max_batch=4, max_wait_ms=20, uncertainty=True)
    try:
        got = [f.result(timeout=60) for f in [mb.submit(s) for s in samples]]
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
    samples = _samples(5, 3)
    mb = mmbt_micro_batcher(tpred, max_batch=4, max_wait_ms=20)
    try:
        got = [f.result(timeout=60) for f in [mb.submit(s) for s in samples]]
    finally:
        mb.close()
    for sample, probs in zip(samples, got):
        np.testing.assert_allclose(probs, _direct(tpred, sample)[0][0], atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


def _post(port, payload, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _body(sample):
    ids, seg, img = sample
    return {"token_ids": ids.tolist(), "segment": seg.tolist(), "image": img.tolist()}


def _round_trip(srv, samples):
    results = {}

    def call(i):
        results[i] = _post(srv.port, _body(samples[i]))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(samples))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return results


def test_http_round_trip_with_uncertainty(predictors):
    _, tpred = predictors
    mb = mmbt_micro_batcher(tpred, max_batch=4, max_wait_ms=20, uncertainty=True)
    srv = PredictionServer(mb, mmbt_request, port=0, encode_result=uncertainty_result).start()
    samples = _samples(6, 4)
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
    ({"token_ids": [1, 2], "segment": [0], "image": np.zeros((4, 4, 3)).tolist()}, "matching"),
    ({"token_ids": [[1, 2]], "segment": [[0, 0]], "image": np.zeros((4, 4, 3)).tolist()},
     "matching"),
    ({"token_ids": [1, 2], "segment": [0, 0], "image": np.zeros((4, 4)).tolist()}, "H, W, 3"),
])
def test_mmbt_request_rejects_bad_payloads(payload, match):
    with pytest.raises(ValueError, match=match):
        mmbt_request(payload)
    srv = PredictionServer(lambda s: np.zeros(2), mmbt_request).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, payload)
        assert e.value.code == 400
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# checkpoints, CLI, devices
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_with_batchnorm_buffers(tmp_path):
    model = _template()
    g = torch.Generator().manual_seed(9)
    for name, buf in model.named_buffers():
        if name.endswith("running_var"):
            buf.uniform_(0.5, 1.5, generator=g)
    path = str(tmp_path / "model_last_epoch.pt")
    save_weights(model, None, path)
    sd, _ = load_weights(path)
    assert "enc.img_encoder.model.layer3.0.bn2.running_var" in sd
    fresh = restore_into(MultimodalBertClf(TB.BertConfig(**BERT), N_CLASSES,
                                           resnet_layers=RESNET), sd)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    del sd["enc.img_encoder.model.layer1.0.bn1.running_mean"]
    with pytest.raises(ValueError, match="missing.*layer1.0.bn1.running_mean"):
        restore_into(_template(), sd)


def _cli_serve(monkeypatch, argv):
    """Run the predict CLI until it would serve forever; return what it built."""
    from multimodal_uncertainty_tpu_torch import predict

    started = {}

    def capture(srv, mb):
        started.update(srv=srv, mb=mb)

    monkeypatch.setattr(predict, "_serve_forever", capture)
    predict.main(argv)
    return started["srv"], started["mb"]


def test_predict_cli_serves_a_tiny_mmbt_checkpoint(tmp_path, monkeypatch):
    """``--tiny`` (hidden 64, 2 heads of 32, ResNet (1, 1, 1, 1)) on the
    CPU: the CLI's answers equal the predictor's on the same checkpoint."""
    from multimodal_uncertainty_tpu_torch.zoo import build_mmbt

    cfg = TB.BertConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=128)
    model = build_mmbt(3, bert_config=cfg, resnet_layers=(1, 1, 1, 1), device="cpu",
                       generator=torch.Generator().manual_seed(2))
    ckpt = str(tmp_path / "model_best_val.pt")
    save_weights(model, None, ckpt)
    srv, mb = _cli_serve(monkeypatch, [
        "--framework", "mmbt", "--serve", "0", "--checkpoint_path", ckpt, "--n_classes", "3",
        "--tiny", "--uncertainty", "--device", "cpu", "--serve_max_batch", "4"])
    samples = _samples(7, 2)
    try:
        results = _round_trip(srv, samples)
    finally:
        srv.close()
        mb.close()
    pred = MMBTPredictor(model, ckpt, batch_buckets=(4,), device="cpu")
    for i, sample in enumerate(samples):
        status, out = results[i]
        assert status == 200 and len(out["probs"]) == 3
        probs, diag = _direct(pred, sample)
        np.testing.assert_allclose(out["probs"], probs[0], atol=1e-6)
        assert set(diag) <= set(out)


@pytest.mark.parametrize("extra,match", [
    # ViLT serves and exports since their ports; an artifact is served only over HTTP
    pytest.param(["--framework", "vilt", "--artifact", "out"], "--artifact requires --serve",
                 id="extra0-ViLT is not ported"),
    (["--framework", "mmbt"], "serves only"),
    (["--framework", "mmbt", "--export", "out", "--export_fixed_batch", "0"], "export"),
    (["--framework", "mmbt", "--serve", "0", "--quantize", "int4"], "quantize"),
    (["--framework", "mmbt", "--serve", "0", "--bert_model", "bert-huge"], "bert_model"),
])
def test_predict_cli_mmbt_errors(extra, match, capsys):
    from multimodal_uncertainty_tpu_torch import predict

    with pytest.raises(SystemExit):
        predict.main(["--checkpoint_path", "unused.pt", "--n_classes", "3", *extra])
    assert match in capsys.readouterr().err


def test_predict_cli_mmbt_flags():
    from multimodal_uncertainty_tpu_torch import predict

    args = predict.build_parser().parse_args(
        ["--framework", "mmbt", "--serve", "8080", "--checkpoint_path", "c.pt",
         "--bert_model", "bert-large-uncased", "--num_image_embeds", "4", "--vocab_size", "500"])
    assert (args.framework, args.serve, args.bert_model, args.num_image_embeds,
            args.vocab_size, args.tiny, args.device) == (
        "mmbt", 8080, "bert-large-uncased", 4, 500, False, "cuda")


def test_mmbt_entry_points_default_to_the_card(tmp_path, monkeypatch):
    from multimodal_uncertainty_tpu_torch.zoo import build_mmbt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = str(tmp_path / "model_best_val.pt")
    save_weights(_template(), None, ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MMBTPredictor(_template(), ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mmbt(3, bert_config=TB.BertConfig(**BERT), resnet_layers=RESNET)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cli_serve(monkeypatch, ["--framework", "mmbt", "--serve", "0", "--checkpoint_path",
                                 ckpt, "--n_classes", "3", "--tiny"])
    assert MMBTPredictor(_template(), ckpt, device="cpu").device.type == "cpu"


def test_full_width_mmbt_shapes():
    """BERT-base + ResNet-152 with 3 image embeddings and 101 classes, built
    on the meta device (no memory): the configuration the card serves."""
    from multimodal_uncertainty_tpu_torch.models.bert import BertConfig

    with torch.device("meta"):
        model = MultimodalBertClf(BertConfig.base(), 101)
    sd = model.state_dict()
    assert len(model.enc.encoder.layer) == 12
    assert [len(getattr(model.enc.img_encoder.model, f"layer{i}")) for i in range(1, 5)] == [
        3, 8, 36, 3]
    assert sd["enc.txt_embeddings.word_embeddings.weight"].shape == (30522, 768)
    assert sd["enc.img_embeddings.img_embeddings.weight"].shape == (768, 2048)
    assert sd["clf.weight"].shape == (101, 768)
    assert model.enc.encoder.layer[0].attention.self.n_head == 12
