"""The port's serving slice on the CPU: predictor, micro-batcher, HTTP
server, checkpoints, packed data and the predict CLI.

The predictor is held against the JAX package's FusionPredictor built from a
JAX checkpoint file, with the weights carried across by
``fusion_state_dict_from_jax``; tolerance 1e-5 on probabilities.
"""
import csv
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.models.fusion import FlavaFusionTransformer as JaxFusion
from multimodal_uncertainty_tpu.serving import FusionPredictor as JaxPredictor
from multimodal_uncertainty_tpu.training.checkpoint import save_weights as jax_save_weights
from multimodal_uncertainty_tpu_torch.models.fusion import FlavaFusionTransformer
from multimodal_uncertainty_tpu_torch.models.jax_import import fusion_state_dict_from_jax
from multimodal_uncertainty_tpu_torch.server import (
    PredictionServer,
    fusion_request,
    uncertainty_result,
)
from multimodal_uncertainty_tpu_torch.serving import (
    FusionPredictor,
    MicroBatcher,
    Overloaded,
    fusion_micro_batcher,
)
from multimodal_uncertainty_tpu_torch.training.checkpoint import (
    load_weights,
    restore_into,
    save_weights,
)

D_IMG, D_TXT = 64, 48
WIDTHS = dict(
    out_dim=2, num_classes=3, image_hidden_size=D_IMG, text_hidden_size=D_TXT,
    multimodal_hidden_size=256, multimodal_num_attention_heads=2,
    multimodal_num_hidden_layers=2,
)


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    """(JAX predictor, port predictor) over the same weights."""
    tmp = tmp_path_factory.mktemp("ckpt")
    jmodel = JaxFusion(attn_impl="xla", **WIDTHS)
    rng = np.random.default_rng(0)
    sample = (rng.normal(size=(2, 5, D_IMG)).astype(np.float32),
              rng.normal(size=(2, 4, D_TXT)).astype(np.float32))
    variables = jmodel.init({"params": jax.random.key(3)}, sample, train=False)
    jpath = str(tmp / "jax_model_best_val.pt")
    jax_save_weights(variables, None, jpath, async_write=False)
    jpred = JaxPredictor(jmodel, jpath, template_variables=variables,
                         pad_multiple=8, batch_buckets=(4, 8))

    tpath = str(tmp / "model_best_val.pt")
    save_weights(fusion_state_dict_from_jax(variables["params"]), None, tpath)
    tpred = FusionPredictor(FlavaFusionTransformer(**WIDTHS), tpath, pad_multiple=8,
                            batch_buckets=(4, 8), device="cpu")
    return jpred, tpred


def _batch(seed, n=3, li=10, lt=7):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(n, li, D_IMG)).astype(np.float32)
    txt = rng.normal(size=(n, lt, D_TXT)).astype(np.float32)
    il = rng.integers(1, li + 1, size=n)
    tl = rng.integers(1, lt + 1, size=n)
    return img, txt, il, tl


@pytest.mark.parametrize("ablate", [None, "image", "text"])
def test_predict_matches_jax_predictor(predictors, ablate):
    jpred, tpred = predictors
    img, txt, il, tl = _batch(1)  # n=3 in bucket 4: one fully masked pad row
    kw = dict(img_lengths=il, txt_lengths=tl, ablate=ablate)
    got = tpred.predict(img, txt, **kw)
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, jpred.predict(img, txt, **kw), atol=1e-5, rtol=0)


def test_predict_with_uncertainty_matches_jax_predictor(predictors):
    jpred, tpred = predictors
    img, txt, il, tl = _batch(2, n=5)  # bucket 8
    probs, diag = tpred.predict_with_uncertainty(img, txt, img_lengths=il, txt_lengths=tl)
    ref_probs, ref_diag = jpred.predict_with_uncertainty(
        img, txt, img_lengths=il, txt_lengths=tl
    )
    np.testing.assert_allclose(probs, ref_probs, atol=1e-5, rtol=0)
    assert set(diag) == {"confidence", "image_sensitivity", "text_sensitivity"}
    for k in diag:
        np.testing.assert_allclose(diag[k], ref_diag[k], atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        tpred.predict_with_uncertainty(img, txt, ablate="image")


def test_micro_batcher_results_match_direct(predictors):
    """Coalesced predictions equal per-sample direct predictions."""
    _, tpred = predictors
    rng = np.random.default_rng(5)
    samples = [
        (rng.normal(size=(3 + i % 4, D_IMG)).astype(np.float32),
         rng.normal(size=(2 + i % 3, D_TXT)).astype(np.float32))
        for i in range(7)
    ]
    mb = fusion_micro_batcher(tpred, max_batch=4, max_wait_ms=20, uncertainty=True)
    try:
        got = [f.result(timeout=30) for f in [mb.submit(s) for s in samples]]
    finally:
        mb.close()
    for (im, tx), (probs, diag) in zip(samples, got):
        ref, ref_diag = tpred.predict_with_uncertainty(im[None], tx[None])
        np.testing.assert_allclose(probs, ref[0], atol=1e-5)
        for k in diag:
            np.testing.assert_allclose(diag[k], ref_diag[k][0], atol=1e-5)


# ---------------------------------------------------------------------------
# MicroBatcher semantics (the cases of tests/test_serving.py)
# ---------------------------------------------------------------------------


def _coalesces():
    calls = []

    def predict_batch(samples):
        calls.append(len(samples))
        time.sleep(0.01)
        return [s * 2 for s in samples]

    mb = MicroBatcher(predict_batch, max_batch=16, max_wait_ms=50)
    futs = [mb.submit(i) for i in range(12)]
    assert [f.result(timeout=10) for f in futs] == [i * 2 for i in range(12)]
    mb.close()
    assert sum(calls) == 12 and len(calls) < 12, calls


def _error_propagation_and_close():
    def boom(samples):
        raise RuntimeError("backend down")

    mb = MicroBatcher(boom, max_batch=4, max_wait_ms=5)
    with pytest.raises(RuntimeError, match="backend down"):
        mb.submit(1).result(timeout=10)
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(2)


def _respects_max_batch():
    calls = []

    def predict_batch(samples):
        calls.append(len(samples))
        return samples

    mb = MicroBatcher(predict_batch, max_batch=3, max_wait_ms=100)
    [f.result(timeout=10) for f in [mb.submit(i) for i in range(9)]]
    mb.close()
    assert max(calls) <= 3


def _survives_cancelled_futures():
    def predict_batch(samples):
        time.sleep(0.05)
        return [s + 1 for s in samples]

    mb = MicroBatcher(predict_batch, max_batch=4, max_wait_ms=30)
    f1 = mb.submit(10)
    cancelled = f1.cancel()
    assert mb.submit(20).result(timeout=10) == 21
    if cancelled:
        assert f1.cancelled()
    assert mb.submit(30).result(timeout=10) == 31
    mb.close()


def _close_serves_accepted_requests():
    mb = MicroBatcher(lambda xs: [x * 3 for x in xs], max_batch=64, max_wait_ms=1)
    futs = []

    def submitter():
        for i in range(50):
            try:
                futs.append((i, mb.submit(i)))
            except RuntimeError:
                return  # closed: acceptable, must not hang

    t = threading.Thread(target=submitter)
    t.start()
    mb.close()
    t.join(timeout=10)
    assert not t.is_alive()
    for i, f in futs:
        assert f.result(timeout=10) == i * 3


def _backpressure_overloaded():
    release = threading.Event()

    def slow_predict(samples):
        release.wait(timeout=10)
        return [s * 2 for s in samples]

    mb = MicroBatcher(slow_predict, max_batch=1, max_wait_ms=1, max_pending=2)
    try:
        futs = [mb.submit(1)]
        time.sleep(0.05)  # the collector claims it and blocks
        futs += [mb.submit(2), mb.submit(3)]
        with pytest.raises(Overloaded):
            mb.submit(4)
        release.set()
        assert sorted(f.result(timeout=10) for f in futs) == [2, 4, 6]
        assert mb.submit(5).result(timeout=10) == 10
    finally:
        release.set()
        mb.close()


def _wrong_result_count_fails_the_batch():
    mb = MicroBatcher(lambda xs: xs[:-1], max_batch=4, max_wait_ms=20)
    futs = [mb.submit(i) for i in range(2)]
    for f in futs:
        with pytest.raises(ValueError, match="returned"):
            f.result(timeout=10)
    mb.close()


@pytest.mark.parametrize("case", [
    _coalesces, _error_propagation_and_close, _respects_max_batch,
    _survives_cancelled_futures, _close_serves_accepted_requests,
    _backpressure_overloaded, _wrong_result_count_fails_the_batch,
], ids=lambda f: f.__name__.strip("_"))
def test_micro_batcher(case):
    case()


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


def _post(port, path, payload, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(port, path, timeout=10):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _status_of(fn):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    return e.value.code


def test_http_round_trip_with_uncertainty(predictors):
    _, tpred = predictors
    mb = fusion_micro_batcher(tpred, max_batch=4, max_wait_ms=20, uncertainty=True)
    srv = PredictionServer(mb, fusion_request, port=0,
                           encode_result=uncertainty_result).start()
    try:
        rng = np.random.default_rng(9)
        samples = [(rng.normal(size=(6, D_IMG)).astype(np.float32),
                    rng.normal(size=(3 + i, D_TXT)).astype(np.float32)) for i in range(4)]
        results = {}

        def call(i):
            im, tx = samples[i]
            results[i] = _post(srv.port, "/v1/predict", {"img": im.tolist(), "txt": tx.tolist()})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for i, (im, tx) in enumerate(samples):
            status, out = results[i]
            assert status == 200
            probs, diag = tpred.predict_with_uncertainty(im[None], tx[None])
            np.testing.assert_allclose(out["probs"], probs[0], atol=1e-5)
            for k in diag:
                np.testing.assert_allclose(out[k], diag[k][0], atol=1e-5)
        _, health = _get(srv.port, "/healthz")
        assert health == {"status": "ok", "requests": 4}
        _, stats = _get(srv.port, "/statz")
        assert stats["errors"] == 0 and stats["pending"] == 0 and stats["mean_ms"] > 0
    finally:
        srv.close()
        mb.close()


def test_http_error_codes():
    srv = PredictionServer(lambda s: np.zeros(2), fusion_request, max_body_bytes=4096).start()
    try:
        p = srv.port
        assert _status_of(lambda: _post(p, "/v1/predict", {"img": [[1.0]]})) == 400
        assert _status_of(lambda: _post(p, "/v1/predict", {"img": [1.0], "txt": [[1.0]]})) == 400
        assert _status_of(lambda: _post(p, "/nope", {})) == 404
        assert _status_of(lambda: _get(p, "/nope")) == 404
        big = {"img": [[0.0] * 300] * 10, "txt": [[0.0]]}
        assert _status_of(lambda: _post(p, "/v1/predict", big)) == 413
        _, stats = _get(p, "/statz")
        assert stats["errors"] == 3  # 404s are not predictor errors
    finally:
        srv.close()

    def boom(sample):
        raise RuntimeError("device on fire")

    def reject(sample):
        raise Overloaded("2 requests pending (max_pending=2)")

    for batcher, code in ((boom, 500), (reject, 503)):
        srv = PredictionServer(batcher, fusion_request).start()
        try:
            assert _status_of(
                lambda: _post(srv.port, "/v1/predict", {"img": [[1.0]], "txt": [[1.0]]})
            ) == code
        finally:
            srv.close()


def test_http_503_after_close_starts():
    srv = PredictionServer(lambda s: np.zeros(2), fusion_request).start()
    try:
        srv._closed = True  # the window between close() and the listener stopping
        assert _status_of(
            lambda: _post(srv.port, "/v1/predict", {"img": [[1.0]], "txt": [[1.0]]})
        ) == 503
        assert _get(srv.port, "/healthz")[1]["status"] == "closed"
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# Checkpoints, packed data, CLI
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_and_strict_restore(tmp_path):
    g = torch.Generator().manual_seed(0)
    model = FlavaFusionTransformer(generator=g, **WIDTHS)
    path = str(tmp_path / "model_last_epoch.pt")
    save_weights(model, None, path)
    sd, opt = load_weights(path)
    assert opt == {}
    fresh = restore_into(FlavaFusionTransformer(**WIDTHS), sd)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_into(FlavaFusionTransformer(**{**WIDTHS, "num_classes": 4}), sd)
    with pytest.raises(ValueError, match="keys differ"):
        restore_into(FlavaFusionTransformer(cls_token=True, **WIDTHS), sd)


def _write_shards(shard_dir, n, d, rng):
    os.makedirs(shard_dir, exist_ok=True)
    imgs = [rng.normal(size=(rng.integers(5, 9), d)).astype(np.float32) for _ in range(n)]
    txts = [rng.normal(size=(rng.integers(2, 7), d)).astype(np.float32) for _ in range(n)]
    for name, parts in (("img", imgs), ("txt", txts)):
        np.save(os.path.join(shard_dir, f"test_{name}.npy"), np.concatenate(parts))
        np.save(os.path.join(shard_dir, f"test_{name}_offsets.npy"),
                np.cumsum([0] + [len(p) for p in parts]))
    np.save(os.path.join(shard_dir, "test_labels.npy"), rng.integers(0, 3, size=n))


def test_packed_dataset_and_collate_match_jax(tmp_path):
    from multimodal_uncertainty_tpu.data import flava_encoded as J
    from multimodal_uncertainty_tpu_torch.data import flava_encoded as T

    _write_shards(str(tmp_path), 5, 16, np.random.default_rng(0))
    tds, jds = T.PackedFlavaDataset(str(tmp_path), "test"), J.PackedFlavaDataset(str(tmp_path), "test")
    assert T.has_packed(str(tmp_path), "test") and len(tds) == len(jds) == 5
    (ti, tt), ty = T.collate_fn_flava([tds[i] for i in range(5)])
    (ji, jt), jy = J.collate_fn_flava([jds[i] for i in range(5)])
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(ty, jy)
    # bf16 shards (raw 2-byte void on disk) widen to float32 exactly
    bits = (np.float32(1.5).view(np.uint32) >> 16).astype(np.uint16)
    assert T._rows_as_float32(np.full((2, 3), bits).view("V2")).tolist() == [[1.5] * 3] * 2


def test_predict_cli_takes_the_export_options_and_rejects_export(capsys):
    """The root ``predict.py``'s ``--export_*`` options (:260-271) parse with
    its types and defaults, and ``--export`` is rejected where the root CLI
    rejects it: without a checkpoint, or with a batch size below 1 baked in
    (tests/test_torch_export.py exports)."""
    from multimodal_uncertainty_tpu_torch import predict

    parser = predict.build_parser()
    args = parser.parse_args(["--checkpoint_path", "c.pt"])
    assert (args.export, args.export_img_len, args.export_txt_len, args.export_ablations,
            args.export_fixed_batch, args.artifact) == (None, 224, 96, False, None, None)
    args = parser.parse_args(["--checkpoint_path", "c.pt", "--export_img_len", "256",
                              "--export_txt_len", "96", "--export_ablations",
                              "--export_fixed_batch", "8", "--export", "out"])
    assert (args.export, args.export_img_len, args.export_txt_len, args.export_ablations,
            args.export_fixed_batch) == ("out", 256, 96, True, 8)
    with pytest.raises(SystemExit):
        predict.main(["--export_txt_len", "96", "--export", "out"])
    assert "--checkpoint_path is required" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        predict.main(["--checkpoint_path", "c.pt", "--export", "out", "--export_fixed_batch", "0"])
    assert "--export_fixed_batch must be at least 1" in capsys.readouterr().err


def test_predict_cli_batch_csv(tmp_path, monkeypatch):
    from multimodal_uncertainty_tpu_torch import predict
    from multimodal_uncertainty_tpu_torch.data.flava_encoded import (
        PackedFlavaDataset,
        collate_fn_flava,
    )
    from multimodal_uncertainty_tpu_torch.zoo import build_flava

    shard_dir = tmp_path / "hateful-meme-dataset" / "flava_packed"
    _write_shards(str(shard_dir), 5, 768, np.random.default_rng(1))
    model = build_flava("MIMO-shuffle-instance", 3, layers=1, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    ckpt = str(tmp_path / "model_best_val.pt")
    save_weights(model, None, ckpt)
    monkeypatch.setenv("DATA_DIR", str(tmp_path))
    out = str(tmp_path / "pred.csv")
    argv = ["--checkpoint_path", ckpt, "--model_type", "MIMO-shuffle-instance",
            "--multimodal_num_hidden_layers", "1", "--n_classes", "3", "--batch_size", "4",
            "--uncertainty", "--device", "cpu", "--out", out]
    predict.main(argv)
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 5
    assert set(rows[0]) == {"index", "label", "pred", "p0", "p1", "p2", "confidence",
                            "image_sensitivity", "text_sensitivity"}

    ds = PackedFlavaDataset(str(shard_dir), "test")
    pred = FusionPredictor(model, ckpt, batch_buckets=(4,), device="cpu")
    for start in (0, 4):
        items = [ds[i] for i in range(start, min(start + 4, 5))]
        (img, txt), _ = collate_fn_flava(items)
        probs = pred.predict(img, txt, img_lengths=np.asarray([i.shape[0] for i, _, _ in items]),
                             txt_lengths=np.asarray([t.shape[0] for _, t, _ in items]))
        for j, p in enumerate(probs):
            row = rows[start + j]
            np.testing.assert_allclose([float(row[f"p{c}"]) for c in range(3)], p, atol=1e-6)
            assert int(row["pred"]) == int(p.argmax())

    # --quantize int8 (the CPU's exact int32 product): within the JAX test's bounds of fp32
    out_q = str(tmp_path / "pred_int8.csv")
    predict.main(argv[:-1] + [out_q, "--quantize", "int8"])
    with open(out_q) as f:
        rows_q = list(csv.DictReader(f))
    probs = np.asarray([[float(r[f"p{c}"]) for c in range(3)] for r in rows])
    probs_q = np.asarray([[float(r[f"p{c}"]) for c in range(3)] for r in rows_q])
    np.testing.assert_allclose(probs_q.sum(-1), 1.0, atol=1e-5)
    assert 0 < np.abs(probs_q - probs).max() < 0.05
    assert (probs_q.argmax(-1) == probs.argmax(-1)).mean() >= 2 / 3
    with pytest.raises(SystemExit):
        predict.main(argv + ["--framework", "mmbt"])
