"""The port's model-code-free artifacts (``export.py`` on ``torch.export``) on
the CPU: each family's artifact against the port's live predictor on the same
inputs (1e-5) and against the JAX package's predictor over the same weights
(1e-4; 1e-3 under int8, where a rounding tie moves one int8 step).

Covered: a symbolic batch at three sizes, FLAVA's symbolic lengths, a fixed
batch (through the predict CLI), the temperature and the int8 mode baked in,
MMBT's ablation keep mask, ``--uncertainty`` through the three artifact
micro-batchers, ``--artifact DIR --serve`` over HTTP on an ephemeral port, a
subprocess that loads and serves an artifact without any model code, and the
sha256 refusal of a tampered program. The attention operator the programs
call runs its plain version on the CPU (``torch.ops.mmu.attention_fwd``).
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

import test_torch_quant as TQ
from multimodal_uncertainty_tpu_torch import export as E
from multimodal_uncertainty_tpu_torch.training.checkpoint import save_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAVA_LEN = (16, 8)  # TQ.fusion_batch's 10 image / 7 text tokens, padded to 8


def _fusion_inputs(img, txt, il, tl, li=FLAVA_LEN[0], lt=FLAVA_LEN[1]):
    """The padded arrays and true-length masks FusionPredictor.predict builds."""
    n = img.shape[0]
    img_p = np.zeros((n, li, img.shape[2]), np.float32)
    txt_p = np.zeros((n, lt, txt.shape[2]), np.float32)
    img_p[:, : img.shape[1]], txt_p[:, : txt.shape[1]] = img, txt
    return (img_p, txt_p, np.arange(li)[None] < np.asarray(il)[:, None],
            np.arange(lt)[None] < np.asarray(tl)[:, None])


@pytest.fixture(scope="module")
def flava(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flava_export")
    ckpts = TQ.checkpoints("flava", tmp)
    live = TQ.port_predictor("flava", ckpts[3])
    E.export_fusion_predictor(live, str(tmp / "sym"), img_len=FLAVA_LEN[0],
                              txt_len=FLAVA_LEN[1], embed_dim=64, txt_embed_dim=48)
    baked = TQ.port_predictor("flava", ckpts[3], quantize="int8", temperature=1.7)
    E.export_fusion_predictor(baked, str(tmp / "lengths"), img_len=FLAVA_LEN[0],
                              txt_len=FLAVA_LEN[1], embed_dim=64, txt_embed_dim=48,
                              symbolic_lengths=True)
    return dict(tmp=tmp, ckpts=ckpts, live=live, baked=baked,
                jax=TQ.jax_predictor("flava", ckpts),
                sym=E.load_exported(str(tmp / "sym"), device="cpu"),
                lengths=E.load_exported(str(tmp / "lengths"), device="cpu"))


@pytest.fixture(scope="module")
def mmbt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mmbt_export")
    ckpts = TQ.checkpoints("mmbt", tmp)
    live = TQ.port_predictor("mmbt", ckpts[3])
    E.export_mmbt_predictor(live, str(tmp / "art"), txt_len=24, image_size=TQ.MMBT_IMG,
                            with_ablations=True)
    return dict(tmp=tmp, ckpts=ckpts, live=live,
                art=E.load_exported(str(tmp / "art"), device="cpu"))


@pytest.fixture(scope="module")
def vilt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vilt_export")
    ckpts = TQ.checkpoints("vilt", tmp)
    live = TQ.port_predictor("vilt", ckpts[3])
    E.export_vilt_predictor(live, str(tmp / "art"), txt_len=16)
    return dict(tmp=tmp, ckpts=ckpts, live=live,
                art=E.load_exported(str(tmp / "art"), device="cpu"))


@pytest.mark.parametrize("n", [1, 3, 9])
def test_fusion_symbolic_batch_matches_live_and_jax(flava, n):
    img, txt, il, tl = TQ.fusion_batch(n, n=n)
    got = flava["sym"](*_fusion_inputs(img, txt, il, tl))
    assert got.shape == (n, 3)
    live = flava["live"].predict(img, txt, img_lengths=il, txt_lengths=tl)
    np.testing.assert_allclose(got, live, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        got, flava["jax"].predict(img, txt, img_lengths=il, txt_lengths=tl), atol=1e-4, rtol=0)
    meta = flava["sym"].meta
    assert meta["kernels"] is True and meta["fixed_batch"] is None
    assert [i["shape"][1:] for i in meta["inputs"]] == [["16", "64"], ["8", "48"], ["16"], ["8"]]
    assert len({i["shape"][0] for i in meta["inputs"]}) == 1  # one shared symbolic batch


@pytest.mark.parametrize("li,lt", [(8, 16), (24, 8)])
def test_fusion_symbolic_lengths_with_baked_temperature_and_int8(flava, li, lt):
    art = flava["lengths"]
    assert (art.meta["symbolic_lengths"], art.meta["temperature"], art.meta["quantize"]) == (
        True, 1.7, "int8")
    img, txt, il, tl = TQ.fusion_batch(li + lt, n=3, li=li, lt=lt)
    got = art(*_fusion_inputs(img, txt, il, tl, li, lt))
    live = flava["baked"].predict(img, txt, img_lengths=il, txt_lengths=tl)
    np.testing.assert_allclose(got, live, atol=1e-5, rtol=0)
    jpred = TQ.jax_predictor("flava", flava["ckpts"], quantize="int8", temperature=1.7)
    np.testing.assert_allclose(got, jpred.predict(img, txt, img_lengths=il, txt_lengths=tl),
                               atol=1e-3, rtol=0)
    # lengths past the baked ones are taken: they pad to the coalesced batch's longest
    mb = E.artifact_micro_batcher(art, max_batch=4, max_wait_ms=50)
    try:
        out = [f.result(timeout=60) for f in [mb.submit((img[i, :il[i]], txt[i, :tl[i]]))
                                              for i in range(3)]]
    finally:
        mb.close()
    np.testing.assert_allclose(np.stack(out), live, atol=1e-5, rtol=0)


def _samples(family, seed, n):
    """Single HTTP-style samples of ``family``, and one batch for the live predictor each."""
    if family == "flava":
        img, txt, il, tl = TQ.fusion_batch(seed, n=n)
        return [((img[i, :il[i]], txt[i, :tl[i]]), (img[i:i + 1, :il[i]], txt[i:i + 1, :tl[i]]))
                for i in range(n)]
    if family == "mmbt":
        txt, mask, seg, img = TQ.mmbt_batch(seed, n=n)
        out = []
        for i in range(n):
            k = int(mask[i].sum())
            out.append(((txt[i, :k], seg[i, :k], img[i]),
                        (txt[i:i + 1, :k], mask[i:i + 1, :k], seg[i:i + 1, :k], img[i:i + 1])))
        return out
    batch = TQ.vilt_batch(seed, n=n)
    out = []
    for i in range(n):
        k = int(batch["attention_mask"][i].sum())
        s = {key: (v[i, :k] if v.ndim == 2 else v[i]) for key, v in batch.items()}
        out.append((s, ({key: v[None] for key, v in s.items()},)))
    return out


@pytest.mark.parametrize("family", ["flava", "mmbt", "vilt"])
def test_artifact_micro_batcher_serves_uncertainty_as_the_live_predictor(
        family, flava, mmbt, vilt):
    fx = {"flava": flava, "mmbt": mmbt, "vilt": vilt}[family]
    art = fx["sym"] if family == "flava" else fx["art"]
    samples = _samples(family, 11, 5)
    mb = E.artifact_micro_batcher(art, max_batch=4, max_wait_ms=50, uncertainty=True)
    try:
        got = [f.result(timeout=120) for f in [mb.submit(s) for s, _ in samples]]
    finally:
        mb.close()
    # JAX on the whole batch the samples were cut from (one shape: one compile)
    jpred = TQ.jax_predictor(family, fx["ckpts"])
    if family == "flava":
        img, txt, il, tl = TQ.fusion_batch(11, n=5)
        # zeros past the lengths, as the samples are padded: a head past the last kept token
        # reads the first masked one
        img = img * (np.arange(img.shape[1])[None, :, None] < il[:, None, None])
        txt = txt * (np.arange(txt.shape[1])[None, :, None] < tl[:, None, None])
        jref, jdiag = jpred.predict_with_uncertainty(img, txt, img_lengths=il, txt_lengths=tl)
    elif family == "mmbt":
        jref, jdiag = jpred.predict_with_uncertainty(*TQ.mmbt_batch(11, n=5))
    else:
        jref, jdiag = jpred.predict_with_uncertainty(TQ.vilt_batch(11, n=5))
    for i, ((probs, diag), (_, direct)) in enumerate(zip(got, samples)):
        ref, ref_diag = fx["live"].predict_with_uncertainty(*direct)
        np.testing.assert_allclose(probs, ref[0], atol=1e-5, rtol=0)
        np.testing.assert_allclose(probs, jref[i], atol=1e-4, rtol=0)
        assert set(diag) == set(ref_diag)
        for k in diag:
            np.testing.assert_allclose(diag[k], ref_diag[k][0], atol=1e-5, rtol=0)
            np.testing.assert_allclose(diag[k], jdiag[k][i], atol=1e-4, rtol=0)


def test_mmbt_ablations_are_a_keep_mask_input(mmbt):
    art = mmbt["art"]
    assert art.meta["ablations"] and art.meta["num_image_embeds"] == 3
    assert art.meta["inputs"][-1] == {"shape": [art.meta["inputs"][0]["shape"][0], "29"],
                                      "dtype": "torch.bool"}
    no_ablations = E.ExportedPredictor.__new__(E.ExportedPredictor)
    no_ablations.meta = {**art.meta, "ablations": False}
    with pytest.raises(ValueError, match="with_ablations"):
        E.artifact_micro_batcher(no_ablations, uncertainty=True)


def _post(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_predict_cli_serves_an_artifact_over_http(mmbt, monkeypatch):
    from multimodal_uncertainty_tpu_torch import predict

    started = {}
    monkeypatch.setattr(predict, "_serve_forever", lambda srv, mb: started.update(srv=srv, mb=mb))
    predict.main(["--artifact", str(mmbt["tmp"] / "art"), "--serve", "0", "--uncertainty",
                  "--device", "cpu", "--serve_max_batch", "4"])
    srv, mb = started["srv"], started["mb"]
    try:
        for (ids, seg, img), direct in _samples("mmbt", 12, 2):
            status, out = _post(srv.port, {"token_ids": ids.tolist(), "segment": seg.tolist(),
                                           "image": img.tolist()})
            ref, diag = mmbt["live"].predict_with_uncertainty(*direct)
            assert status == 200 and set(diag) <= set(out)
            np.testing.assert_allclose(out["probs"], ref[0], atol=1e-5, rtol=0)
    finally:
        srv.close()
        mb.close()
    with pytest.raises(SystemExit):
        predict.main(["--artifact", str(mmbt["tmp"] / "art"), "--device", "cpu"])


_SERVE_IN_SUBPROCESS = """
import json, sys, urllib.request
sys.modules["jax"] = None
from multimodal_uncertainty_tpu_torch import predict

def serve_once(srv, mb):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/predict",
                                 data=sys.stdin.read().encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        answer = json.loads(r.read())
    srv.close()
    mb.close()
    mods = sorted(m for m in sys.modules if m.startswith("multimodal_uncertainty_tpu_torch"))
    print(json.dumps({"answer": answer, "modules": mods}))

predict._serve_forever = serve_once
predict.main(["--artifact", sys.argv[1], "--serve", "0", "--device", "cpu"])
"""


def test_an_artifact_loads_and_serves_without_model_code(flava):
    """A fresh process serves the int8, symbolic-lengths artifact through the
    predict CLI: nothing of ``models/``, ``zoo`` or ``serving`` is imported."""
    img, txt, il, tl = TQ.fusion_batch(21, n=1)
    body = json.dumps({"img": img[0, :il[0]].tolist(), "txt": txt[0, :tl[0]].tolist()})
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _SERVE_IN_SUBPROCESS, str(flava["tmp"] / "lengths")],
                       input=body, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    bad = [m for m in out["modules"] if any(
        m.startswith(f"multimodal_uncertainty_tpu_torch.{p}") for p in ("models", "zoo", "serving"))]
    assert not bad, bad
    assert "multimodal_uncertainty_tpu_torch.ops.attention" in out["modules"]
    live = flava["baked"].predict(img[:, :il[0]], txt[:, :tl[0]])
    np.testing.assert_allclose(out["answer"]["probs"], live[0], atol=1e-5, rtol=0)


def test_a_tampered_program_is_refused(vilt, tmp_path):
    art = str(tmp_path / "tampered")
    shutil.copytree(str(vilt["tmp"] / "art"), art)
    program = os.path.join(art, E.PROGRAM_FILE)
    with open(program, "r+b") as f:
        f.seek(os.path.getsize(program) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="integrity check failed"):
        E.load_exported(art, device="cpu")
    meta = json.load(open(os.path.join(art, E.META_FILE)))
    assert meta["sha256"][E.PROGRAM_FILE] != E._sha256(program)


def _cli_checkpoint(family, tmp):
    """A port checkpoint of the predict CLI's ``--tiny`` (mmbt, vilt) or a
    one-layer FLAVA template, with its predictor's arguments."""
    from multimodal_uncertainty_tpu_torch.models.bert import BertConfig
    from multimodal_uncertainty_tpu_torch.models.vilt import ViltConfig
    from multimodal_uncertainty_tpu_torch.zoo import build_flava, build_mmbt, build_vilt

    g = torch.Generator().manual_seed(7)
    if family == "flava":
        model = build_flava("MIMO-shuffle-instance", 3, layers=1, device="cpu", generator=g)
    elif family == "mmbt":
        cfg = dataclasses.replace(BertConfig.base(), hidden_size=64, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=128, vocab_size=128)
        model = build_mmbt(3, bert_config=cfg, resnet_layers=(1, 1, 1, 1), device="cpu",
                           generator=g)
    else:
        cfg = dataclasses.replace(ViltConfig.b32(), hidden_size=64, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=128, num_labels=3)
        model = build_vilt(3, vilt_config=cfg, device="cpu", generator=g)
    ckpt = str(tmp / f"{family}.pt")
    save_weights(model, None, ckpt)
    return model, ckpt


@pytest.mark.parametrize("family,extra", [
    ("flava", ["--export_fixed_batch", "4", "--model_type", "MIMO-shuffle-instance",
               "--multimodal_num_hidden_layers", "1", "--export_img_len", "32",
               "--export_txt_len", "32", "--temperature", "0.8"]),
    ("mmbt", ["--tiny", "--vocab_size", "128", "--export_ablations", "--export_txt_len", "16",
              "--quantize", "int8_weight"]),
    ("vilt", ["--tiny", "--quantize", "int8"]),
])
def test_predict_cli_exports_each_family(family, extra, tmp_path, capsys):
    from multimodal_uncertainty_tpu_torch import predict
    from multimodal_uncertainty_tpu_torch.serving import (
        FusionPredictor,
        MMBTPredictor,
        ViltPredictor,
    )

    model, ckpt = _cli_checkpoint(family, tmp_path)
    art = str(tmp_path / "art")
    predict.main(["--framework", family, "--checkpoint_path", ckpt, "--n_classes", "3",
                  "--device", "cpu", "--export", art, *extra])
    assert f"exported {family} artifact to {art}" in capsys.readouterr().out
    loaded = E.load_exported(art, device="cpu")
    rng = np.random.default_rng(3)
    if family == "flava":
        assert loaded.meta["fixed_batch"] == 4 and loaded.meta["temperature"] == 0.8
        assert all(i["shape"][0] == "4" for i in loaded.meta["inputs"])
        live = FusionPredictor(model, ckpt, temperature=0.8, device="cpu")
        samples = [(rng.normal(size=(20, 768)).astype(np.float32),
                    rng.normal(size=(9 + i, 768)).astype(np.float32)) for i in range(3)]
        want = [live.predict(a[None], b[None])[0] for a, b in samples]
    elif family == "mmbt":
        assert loaded.meta["ablations"] and loaded.meta["quantize"] == "int8_weight"
        live = MMBTPredictor(model, ckpt, quantize="int8_weight", device="cpu")
        samples = [(rng.integers(0, 128, size=9 + i), np.zeros(9 + i, np.int64),
                    rng.normal(size=(224, 224, 3)).astype(np.float32)) for i in range(3)]
        want = [live.predict(s[0][None], np.ones((1, len(s[0])), np.int64), s[1][None],
                             s[2][None])[0] for s in samples]
    else:
        assert loaded.meta["txt_len"] == 40 and loaded.meta["quantize"] == "int8"  # cut to 40
        live = ViltPredictor(model, ckpt, quantize="int8", device="cpu")
        samples = [{"input_ids": rng.integers(104, 30522, size=5 + 9 * i),
                    "attention_mask": np.ones(5 + 9 * i, np.int64),
                    "pixel_values": rng.normal(size=(384, 384, 3)).astype(np.float32)}
                   for i in range(3)]
        want = [live.predict({k: v[None] for k, v in s.items()})[0] for s in samples]
    mb = E.artifact_micro_batcher(loaded, max_wait_ms=50)
    try:
        got = [f.result(timeout=120) for f in [mb.submit(s) for s in samples]]
    finally:
        mb.close()
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-5, rtol=0)


def test_bench_export_rows(capsys):
    """``tools/bench_export.py`` on the CPU at a toy size: the live forward,
    the symbolic-batch and the fixed-batch artifact, equal answers."""
    from multimodal_uncertainty_tpu_torch.tools import bench_export

    rows = bench_export.main(["--device", "cpu", "--batch", "2", "--img_len", "32",
                              "--txt_len", "32", "--layers", "1", "--iters", "1"])
    assert [r["row"] for r in rows] == ["live", "artifact (symbolic batch)",
                                        "artifact (fixed batch 2)"]
    assert all(r["ms"] > 0 and r["max_abs_dp_vs_live"] <= 1e-6 for r in rows)
    assert capsys.readouterr().out.startswith("card: cpu")
