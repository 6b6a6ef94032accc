"""The port's ViLT training slice, and ``--fast_dw`` on every family, against JAX, on the CPU.

``setup_vilt`` in both packages from the same weights (the JAX init, carried
over by ``vilt_state_dict_from_jax``): a ViLT 128 wide (2 layers, 2 heads of
64, FFN 256, 384x384 images), so that every block's qkv, proj, fc1 and fc2,
the pooler and ``cls_fc`` have widths that are multiples of 128 and take the
dW route. The JAX side runs ``fast_dw="interpret"`` (its Pallas dW kernel in
interpret mode) and its XLA attention; the port runs ``fast_dw=True``, whose
CPU route is ``dw_plain``, and its plain attention.

Tolerances: per-step losses within 1e-5 relative; parameters, AdamW moments
and accumulated gradients within 1e-5, except the key bias (qkv's bias
columns D..2D), whose true gradient is exactly 0: each package's rounding
noise there, which AdamW normalises into steps of up to lr, is bounded by
2 x the sum of the learning rates (ROADMAP Queue 3).
"""
import dataclasses
import json
import logging
import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.models.vilt import ViltConfig as JaxConfig
from multimodal_uncertainty_tpu.training.steps import build_train_step
from multimodal_uncertainty_tpu.zoo import setup_vilt as jax_setup_vilt
from multimodal_uncertainty_tpu_torch import train as port_train
from multimodal_uncertainty_tpu_torch import zoo as port_zoo
from multimodal_uncertainty_tpu_torch.data.images import write_ppm
from multimodal_uncertainty_tpu_torch.models import bert as TB
from multimodal_uncertainty_tpu_torch.models.jax_import import vilt_state_dict_from_jax
from multimodal_uncertainty_tpu_torch.models.vilt import ViltConfig
from multimodal_uncertainty_tpu_torch.ops import dw
from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights
from multimodal_uncertainty_tpu_torch.training.loop import load_history, resume_train_state
from multimodal_uncertainty_tpu_torch.training.steps import to_device, train_step
from multimodal_uncertainty_tpu_torch.training.trainer import Trainer
from multimodal_uncertainty_tpu_torch.zoo import setup_flava, setup_mmbt, setup_vilt

WIDE = dict(vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=256, num_labels=5, image_size=384)
LR = 1e-4


def _batches(n, seed, bsz=4, lt=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(3, lt + 1, size=bsz)
        mask = (np.arange(lt)[None] < lengths[:, None]).astype(np.int64)
        x = {"input_ids": rng.integers(104 % WIDE["vocab_size"], WIDE["vocab_size"],
                                       size=(bsz, lt)) * mask,
             "attention_mask": mask,
             "token_type_ids": np.zeros((bsz, lt), np.int64),
             "pixel_values": rng.integers(0, 256, size=(bsz, 384, 384, 3), dtype=np.uint8),
             "pixel_mask": np.ones((bsz, 384, 384), np.int64)}
        out.append((x, rng.integers(0, WIDE["num_labels"], size=bsz)))
    return out


def _counting(monkeypatch):
    calls = []
    real = dw.weight_grad

    def counted(x2d, dy2d):
        calls.append((tuple(x2d.shape), tuple(dy2d.shape)))
        return real(x2d, dy2d)

    monkeypatch.setattr(dw, "weight_grad", counted)
    return calls


def test_five_micro_steps_with_fast_dw_and_accumulation_match_jax(monkeypatch):
    js = jax_setup_vilt(n_classes=5, lr=LR, vilt_config=dataclasses.replace(JaxConfig.b32(),
                                                                             **WIDE),
                        gradient_accumulation_steps=2, seed_key=jax.random.key(0),
                        attn_impl="xla", fast_dw="interpret")
    jstep = build_train_step(js.bundle, js.optimizer, gradient_accumulation_steps=2,
                             donate=False)
    state = js.state
    ts = setup_vilt(n_classes=5, lr=LR, vilt_config=dataclasses.replace(ViltConfig.b32(), **WIDE),
                    gradient_accumulation_steps=2, fast_dw=True, device="cpu")
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), state.params)
    ts.model.load_state_dict(vilt_state_dict_from_jax(params), strict=True)
    calls = _counting(monkeypatch)
    for i, (x, y) in enumerate(_batches(5, 3), start=1):
        state, jlogs = jstep(state, {k: jnp.asarray(v) for k, v in x.items()}, jnp.asarray(y),
                             jax.random.key(i))
        tx, ty = to_device((x, y), "cpu")
        tlogs = train_step(ts.bundle, ts.optimizer, tx, ty, torch.Generator().manual_seed(i),
                           accumulator=ts.accumulator)
        np.testing.assert_allclose(float(tlogs["loss"]), float(jlogs["loss"]), rtol=1e-5,
                                   err_msg=f"loss at micro-step {i}")
        assert float(tlogs["acc"]) == pytest.approx(float(jlogs["acc"]), abs=1e-4)
    # 4 per block x 2, the pooler and cls_fc; cls_out (5 outputs) keeps autograd's dW
    k = 4 * (16 + 145)  # B * S, S = text + image [CLS] + 12 x 12 patches
    assert Counter(calls) == {((4, 128), (4, 128)): 5 * 2,  # cls_fc and the pooler: K = B
                              ((k, 128), (k, 384)): 5 * 2, ((k, 128), (k, 128)): 5 * 2,
                              ((k, 128), (k, 256)): 5 * 2, ((k, 256), (k, 128)): 5 * 2}
    assert ts.step == int(state.step) == 5 and ts.optimizer.step == 2

    d = WIDE["hidden_size"]
    bound = 2 * 2 * LR
    want = vilt_state_dict_from_jax({"params": state.params})
    for name, t in ts.model.state_dict().items():
        got, ref = t.numpy(), want[name].numpy()
        if name.endswith("qkv.bias"):
            assert np.abs(got[d:2 * d] - ref[d:2 * d]).max() <= bound, name
            got, ref = np.delete(got, np.s_[d:2 * d]), np.delete(ref, np.s_[d:2 * d])
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=name)
    for key, own, ref in (("mu", ts.optimizer.mu, state.opt_state["mu"]),
                          ("nu", ts.optimizer.nu, state.opt_state["nu"]),
                          ("accumulated", ts.accumulator.grads, state.accum_grads)):
        ref = vilt_state_dict_from_jax({"params": ref})
        for name, t in own.items():
            got, r = t.numpy(), ref[name].numpy()
            if name.endswith("qkv.bias"):
                got, r = np.delete(got, np.s_[d:2 * d]), np.delete(r, np.s_[d:2 * d])
            np.testing.assert_allclose(got, r, atol=1e-5, rtol=1e-5, err_msg=f"{key} {name}")


def test_pixels_are_normalised_on_the_device_and_eval_takes_no_dw_route(monkeypatch):
    ts = setup_vilt(n_classes=5, vilt_config=dataclasses.replace(ViltConfig.b32(), **WIDE),
                    fast_dw=True, device="cpu")
    calls = _counting(monkeypatch)
    x, _ = to_device(_batches(1, 5)[0], "cpu")
    ts.model.eval()
    with torch.no_grad():
        got = ts.bundle.apply_fn(ts.model, x, train=False)
        ref = ts.model({**x, "pixel_values": (x["pixel_values"].float() / 255.0 - 0.5) / 0.5})
    torch.testing.assert_close(got, ref.logits, atol=0, rtol=0)
    assert calls == []


def test_fast_dw_on_flava_and_mmbt_takes_the_route_with_the_same_result(monkeypatch):
    """One train step of each family with and without ``fast_dw``, from the
    same weights: the same loss and parameters (1e-5), and the dW route taken
    by exactly the eligible Linears; a frozen MMBT encoder takes none."""
    calls = _counting(monkeypatch)
    rng = np.random.default_rng(0)
    x = (torch.from_numpy(rng.normal(size=(2, 9, 768)).astype(np.float32)),
         torch.from_numpy(rng.normal(size=(2, 7, 768)).astype(np.float32)))
    y = torch.tensor([1, 0])
    runs = []
    for fast in (False, True):
        s = setup_flava(model_type="MIMO-shuffle-instance", n_classes=3, lr=1e-3,
                        steps_per_epoch=1, multimodal_num_hidden_layers=1, fast_dw=fast,
                        device="cpu")
        logs = train_step(s.bundle, s.optimizer, x, y, torch.Generator().manual_seed(0))
        runs.append((float(logs["loss"]), s.model.state_dict()))
    assert len(calls) == 2 + 4  # the two projections, then in_proj, out_proj, c_fc, c_proj
    assert runs[0][0] == pytest.approx(runs[1][0], rel=1e-6)
    for name, t in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][name], t, atol=1e-5, rtol=0, msg=name)

    bert = dataclasses.replace(TB.BertConfig.base(), vocab_size=128, hidden_size=128,
                               num_hidden_layers=2, num_attention_heads=2, intermediate_size=256)
    text = torch.from_numpy(rng.integers(104 % 128, 128, size=(2, 8)))
    ones = torch.ones(2, 8, dtype=torch.int64)
    imgs = torch.from_numpy(rng.integers(0, 256, size=(2, 64, 64, 3), dtype=np.uint8))
    for flags, expected in (((False, False), 2 * 6 + 2), ((True, True), 2)):
        calls.clear()
        runs = []
        for fast in (False, True):
            s = setup_mmbt(n_classes=3, bert_config=bert, resnet_layers=(1, 1, 1, 1), dropout=0.0,
                           gradient_accumulation_steps=1, lr=1e-3, warmup=0.0, fast_dw=fast,
                           device="cpu")
            logs = train_step(s.bundle, s.optimizer, (text, ones, ones, imgs), y,
                              torch.Generator().manual_seed(0), flags=flags,
                              accumulator=s.accumulator)
            runs.append((float(logs["loss"]), s.model.state_dict()))
        # 6 Linears a BERT layer, the pooler and the image embedding; frozen: the last two
        assert len(calls) == expected, flags
        assert runs[0][0] == pytest.approx(runs[1][0], rel=1e-6)
        for name, t in runs[0][1].items():
            if t.is_floating_point():
                torch.testing.assert_close(runs[1][1][name], t, atol=1e-5, rtol=0, msg=name)


# ---------------------------------------------------------------- the CLI


def _write_tree(root, rng, *, n=(10, 4, 4), labels=("pho", "ramen", "tacos")):
    """A Food-101-style tree: BERT's special ids, 384x384 P6 images."""
    os.makedirs(root, exist_ok=True)
    words = ["the", "soup", "is", "very", "good", "##s", "noodle", "broth", "spicy", "taco"]
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)] + ["[UNK]", "[CLS]", "[SEP]",
                                                                     "[MASK]"] + words
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    for split, count in zip(("train", "dev", "test"), n):
        with open(os.path.join(root, f"{split}.jsonl"), "w") as f:
            for i in range(count):
                img = f"{split}_{i}.ppm"
                write_ppm(os.path.join(root, img), rng.integers(0, 256, (384, 384, 3), np.uint8))
                text = " ".join(rng.choice(words[:5] + words[6:], size=int(rng.integers(2, 50))))
                f.write(json.dumps({"label": labels[i % len(labels)], "text": text,
                                    "img": img}) + "\n")


def _cli(tmp_path, *extra):
    return ["--framework", "vilt", "--dataset", "food101", "--tiny", "--device", "cpu",
            "--save_path", str(tmp_path / "run"), "--batch_size", "4",
            "--gradient_accumulation_steps", "2", "--lr", "1e-4", "--fast_dw", *extra]


def test_vilt_train_cli_on_the_cpu_history_checkpoints_resume(tmp_path, monkeypatch):
    """``--tiny --fast_dw --device cpu`` for 2 epochs with accumulation 2:
    history.csv, the checkpoints with the accumulated gradients and the
    plateau state; a resume reproduces the last val metrics; ``--resume``
    continues to epoch 3 (with attention-probability dropout)."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    _write_tree(str(tmp_path / "data" / "food101"), np.random.default_rng(7))
    port_train.main(_cli(tmp_path, "--n_epochs", "2"))
    run = tmp_path / "run"
    hist = load_history(str(run))
    assert hist["epoch"] == [1, 2] and np.isfinite(hist["loss"]).all()
    assert {"history.csv", "model_best_val.pt", "model_epoch_1.pt", "model_epoch_2.pt",
            "model_last_epoch.pt"} <= set(os.listdir(run))
    _, opt = load_weights(str(run / "model_last_epoch.pt"))
    assert int(opt["step"]) == 2 * 3 and int(opt["opt_state"]["step"]) == 3
    assert set(opt["accum_grads"]) == set(opt["opt_state"]["mu"])
    assert set(opt["scheduler"]) == {"scale", "best", "num_bad_epochs", "cooldown_counter"}

    argv = _cli(tmp_path, "--n_epochs", "2")
    args = port_train.add_conditional_args(port_train.build_parser().parse_args(argv))
    _, valid, _, fresh = port_train._vilt_setup(args, torch.device("cpu"))
    resume_train_state(fresh.model, fresh.optimizer, str(run / "model_last_epoch.pt"),
                       accumulator=fresh.accumulator, plateau=fresh.plateau)
    assert fresh.accumulator.step == 6 and fresh.optimizer.step == 3
    again = Trainer(fresh.bundle, fresh.optimizer, seed=42, verbose=False).eval_loop(valid, "val")
    assert again["val_loss"] == pytest.approx(hist["val_loss"][-1], rel=1e-6)
    assert again["val_acc"] == pytest.approx(hist["val_acc"][-1], abs=1e-6)

    port_train.main(_cli(tmp_path, "--n_epochs", "3", "--resume",
                         "--attention_probs_dropout", "0.1"))
    assert load_history(str(run))["epoch"] == [1, 2, 3]


@pytest.mark.parametrize("flag", [["--batch_decode"]])
def test_vilt_cli_rejects_what_is_not_ported(tmp_path, flag, capsys):
    with pytest.raises(SystemExit):
        port_train.main(_cli(tmp_path) + flag)
    assert "ported to PyTorch yet" in capsys.readouterr().err


def test_vilt_cli_takes_bf16_and_trains_in_fp32(tmp_path, monkeypatch, caplog):
    """``--bf16`` (rejected until the bf16 slice) is taken and ignored for
    ViLT, as the root CLI's vilt branch passes no dtype: a warning says so,
    and one epoch trains with fp32 logits and checkpoints."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    _write_tree(str(tmp_path / "data" / "food101"), np.random.default_rng(7), n=(4, 4, 4))
    logits = []
    real = port_zoo.plain_cross_entropy
    monkeypatch.setattr(port_zoo, "plain_cross_entropy",
                        lambda y_hat, y, **kw: logits.append(y_hat.dtype) or real(y_hat, y, **kw))
    with caplog.at_level(logging.WARNING, logger=port_train.__name__):
        port_train.main(_cli(tmp_path, "--n_epochs", "1", "--bf16"))
    assert "--bf16 ignored for --framework vilt" in caplog.text
    assert logits and set(logits) == {torch.float32}
    model, _ = load_weights(str(tmp_path / "run" / "model_last_epoch.pt"))
    assert all(t.dtype == torch.float32 for t in model.values() if t.is_floating_point())


def test_vilt_cli_takes_remat_and_ignores_it(tmp_path, monkeypatch, caplog):
    """``--remat`` (rejected until this slice) is taken and ignored for ViLT,
    as the root CLI's vilt branch rematerialises nothing: a warning says so,
    and one epoch trains without a rematerialised block."""
    from multimodal_uncertainty_tpu_torch.models import remat

    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    _write_tree(str(tmp_path / "data" / "food101"), np.random.default_rng(8), n=(4, 4, 4))
    calls = []
    real = remat.checkpoint
    monkeypatch.setattr(remat, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with caplog.at_level(logging.WARNING, logger=port_train.__name__):
        trainer = port_train.main(_cli(tmp_path, "--n_epochs", "1", "--remat"))
    assert "--remat ignored for --framework vilt" in caplog.text
    assert calls == [] and load_history(str(tmp_path / "run"))["epoch"] == [1]
    assert trainer.accumulator.step == 1  # 4 rows at batch 4: one micro-step
