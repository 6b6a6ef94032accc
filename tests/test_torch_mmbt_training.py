"""The port's MMBT training slice against the JAX package's, on the CPU.

Weights come from the JAX model's init (BatchNorm scales, biases and running
statistics redrawn from a numpy seed) and cross over through
``mmbt_state_dict_from_jax``; inputs are drawn with numpy and handed to both
packages. The JAX side runs its XLA attention; the port its plain attention
(the CUDA kernels run only on the card).

Tolerances: 1e-6 for the schedule, the plateau scheduler and BatchNorm on
one batch (the same fp32 math); 1e-5 for BertAdam and for five micro-steps of
the tiny MMBT (fp32 summed in another order, then through BertAdam); BERT's
key biases, whose true gradient is exactly 0, within 2 x the sum of the
learning rates (ROADMAP Queue 3).
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.data import food101 as jax_food
from multimodal_uncertainty_tpu.data import images as jax_images
from multimodal_uncertainty_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from multimodal_uncertainty_tpu.data.tokenization import get_vocab as jax_get_vocab
from multimodal_uncertainty_tpu.models import bert as JB
from multimodal_uncertainty_tpu.models.layers import BatchNorm as JaxBatchNorm
from multimodal_uncertainty_tpu.models.mmbt import MultimodalBertClf as JaxMMBT
from multimodal_uncertainty_tpu.models.mmbt import mmbt_grad_mask_fn
from multimodal_uncertainty_tpu.training import optim as jax_optim
from multimodal_uncertainty_tpu import zoo as jax_zoo
from multimodal_uncertainty_tpu.training.state import TrainState
from multimodal_uncertainty_tpu.training.steps import build_train_step
from multimodal_uncertainty_tpu.zoo import setup_mmbt as jax_setup_mmbt
from multimodal_uncertainty_tpu_torch import train as port_train
from multimodal_uncertainty_tpu_torch.data import food101, images
from multimodal_uncertainty_tpu_torch.data.tokenization import BertTokenizer, get_vocab
from multimodal_uncertainty_tpu_torch.models import bert as TB
from multimodal_uncertainty_tpu_torch.models.jax_import import mmbt_state_dict_from_jax
from multimodal_uncertainty_tpu_torch.models.layers import BatchNorm2d
from multimodal_uncertainty_tpu_torch.models.mmbt import MultimodalBertClf, mmbt_frozen_subtrees
from multimodal_uncertainty_tpu_torch.training import optim
from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights
from multimodal_uncertainty_tpu_torch.training.loop import load_history, resume_train_state
from multimodal_uncertainty_tpu_torch.training.steps import GradAccumulator, to_device, train_step
from multimodal_uncertainty_tpu_torch.training.trainer import Trainer
from multimodal_uncertainty_tpu_torch.zoo import setup_mmbt

BERT = dict(vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=256, max_position_embeddings=128, hidden_dropout_prob=0.0)
N_CLASSES, RESNET, IMG = 5, (1, 1, 1, 1), 64


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _port_tree(tree):
    """A params-shaped JAX tree -> the port's names (through the weights'
    converter, so moments and masks take the weights' layout)."""
    return mmbt_state_dict_from_jax({"params": _numpy_tree(tree)})


# ---------------------------------------------------------------- schedule, optimizer


def test_warmup_linear_schedule_matches_jax_and_goes_negative():
    ref = jax_optim.warmup_linear_schedule(5e-5, 0.1, 30.0)
    got = optim.warmup_linear_schedule(5e-5, 0.1, 30.0)
    for step in range(0, 40):
        assert got(step) == pytest.approx(float(ref(jnp.asarray(step))), rel=1e-6, abs=1e-15)
    assert got(0) == 0.0 and got(35) < 0.0  # past t_total, a BertAdam quirk kept


def test_plateau_scheduler_matches_jax():
    metrics = [10.0, 12.0, 12.0, 11.0, 12.0, 11.5, 11.0, 13.0, 13.0, 13.0, 13.0, 12.0]
    ref = jax_optim.ReduceLROnPlateau(mode="max", patience=2, factor=0.5, cooldown=1)
    got = optim.ReduceLROnPlateau(mode="max", patience=2, factor=0.5, cooldown=1)
    scales = []
    for m in metrics:
        scales.append(got.step(m))
        assert scales[-1] == ref.step(m)
        assert got.state_dict() == ref.state_dict()
    assert min(scales) < 1.0  # the scale was cut
    again = optim.ReduceLROnPlateau(mode="max", patience=2, factor=0.5, cooldown=1)
    again.load_state_dict(got.state_dict())
    assert again.state_dict() == got.state_dict()


@functools.lru_cache(maxsize=None)
def _tiny_variables(seed=0):
    """JAX init of the tiny MMBT, BatchNorm scale/bias/statistics redrawn."""
    jmodel = JaxMMBT(config=JB.BertConfig(**BERT), n_classes=N_CLASSES, resnet_layers=RESNET,
                     dropout=0.0, attn_impl="xla")
    x = (jnp.zeros((2, 8), jnp.int32), jnp.ones((2, 8), jnp.int32), jnp.ones((2, 8), jnp.int32),
         jnp.zeros((2, IMG, IMG, 3), jnp.float32))
    variables = jax.jit(functools.partial(jmodel.init, train=False))(
        {"params": jax.random.key(seed)}, x)
    rng = np.random.default_rng(seed)
    params, stats = _numpy_tree(variables["params"]), _numpy_tree(variables["batch_stats"])

    def walk(p, s):
        for key in s:
            if key == "bn":
                c = s["bn"]["mean"].shape
                p["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                p["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                s["bn"]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                s["bn"]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            else:
                walk(p[key], s[key])

    walk(params, stats)
    return {"params": params, "batch_stats": stats}


def test_bert_adam_matches_jax_per_parameter_clip_lagging_step_and_decay_mask():
    """Eight BertAdam steps on the tiny MMBT's parameters with large random
    gradients (so the per-parameter clip acts), the image encoder frozen for
    the first three (its step lags) and the BERT encoder for steps 4-5:
    parameters, moments and per-parameter steps equal the JAX ``bert_adam``'s;
    the decay mask is the JAX ``no_decay_mask``."""
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(jnp.asarray, _tiny_variables()["params"])
    jopt = jax_optim.bert_adam(1e-3, 0.25, 8.0)
    jstate = jopt.init(params)
    model = MultimodalBertClf(TB.BertConfig(**BERT), N_CLASSES, resnet_layers=RESNET, dropout=0.0)
    model.load_state_dict(mmbt_state_dict_from_jax(_tiny_variables()), strict=True)
    opt = optim.BertAdam(model.named_parameters(), 1e-3, 0.25, 8.0)
    want_decay = {n: bool(m) for n, m in _port_tree(jstate["decay_mask"]).items()}
    assert opt.decay == want_decay
    assert not opt.decay["enc.txt_embeddings.LayerNorm.weight"] and opt.decay["clf.weight"]
    assert opt.decay["enc.img_encoder.model.bn1.weight"]  # the reference decays BN scales
    ones = jax.tree_util.tree_map(lambda _: jnp.ones((), jnp.float32), params)
    jupdate = jax.jit(jopt.update)
    for step in range(8):
        flags = jnp.asarray([step < 3, step in (3, 4)])
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * 3), params)
        active = mmbt_grad_mask_fn(ones, flags)
        updates, jstate = jupdate(grads, jstate, params, active)
        params = jax.tree_util.tree_map(jnp.add, params, updates)
        frozen = mmbt_frozen_subtrees([bool(f) for f in flags])
        opt.update(_port_tree(grads), active=[
            n for n in opt.params if not any(n.startswith(f + ".") for f in frozen)])
    want = _port_tree(params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
    for key, own in (("mu", opt.mu), ("nu", opt.nu)):
        ref = _port_tree(jstate[key])
        for name, t in own.items():
            np.testing.assert_allclose(t.numpy(), ref[name].numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=f"{key} {name}")
    steps = _port_tree(jstate["step"])
    assert {n: int(t) for n, t in steps.items()} == opt.steps
    assert opt.steps["clf.weight"] == 8 and opt.steps["enc.img_encoder.model.conv1.weight"] == 5
    assert opt.steps["enc.encoder.layer.0.output.dense.weight"] == 6
    fresh = optim.BertAdam(model.named_parameters(), 1e-3, 0.25, 8.0)
    fresh.load_state_dict(opt.state_dict())
    assert fresh.steps == opt.steps


def test_batchnorm_training_mode_matches_flax_biased_running_variance():
    """Train mode normalises by the batch statistics and moves the running
    variance by the biased batch variance (flax), not torch's unbiased one:
    for this (2, 2, 2, 3) batch flax gives ~1.0397, torch's rule ~1.0597."""
    x = np.random.default_rng(2).normal(size=(2, 2, 2, 3)).astype(np.float32) * 2 + 1
    jbn = JaxBatchNorm(use_running_average=False)
    variables = jbn.init(jax.random.key(0), jnp.asarray(x))
    variables = {"params": {"bn": {"scale": jnp.asarray([0.5, 1.0, 1.5]),
                                   "bias": jnp.asarray([0.1, -0.2, 0.3])}},
                 "batch_stats": {"bn": {"mean": jnp.asarray([0.2, 0.0, -0.1]),
                                        "var": jnp.asarray([1.1, 0.9, 1.0])}}}
    ref, mutated = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm2d(3)
    bn.load_state_dict(mmbt_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    out = bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)
    stats = mutated["batch_stats"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-6)
    unbiased = torch.nn.BatchNorm2d(3).train()
    unbiased.running_var.copy_(torch.tensor([1.1, 0.9, 1.0]))
    unbiased(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert float((unbiased.running_var - bn.running_var).abs().max()) > 1e-2
    bn.eval()  # eval reads the running statistics
    torch.testing.assert_close(
        bn(torch.zeros(1, 3, 1, 1)).flatten(),
        ((0 - bn.running_mean) / torch.sqrt(bn.running_var + 1e-5) * bn.weight + bn.bias).detach())


# ---------------------------------------------------------------- five micro-steps


def _batches(n, seed, bsz=4, lt=24):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(4, lt + 1, size=bsz)
        mask = (np.arange(lt)[None] < lengths[:, None]).astype(np.int64)
        text = rng.integers(104, BERT["vocab_size"], size=(bsz, lt)) * mask
        imgs = rng.integers(0, 256, size=(bsz, IMG, IMG, 3), dtype=np.uint8)
        out.append(((text, mask.copy(), mask, imgs), rng.integers(0, N_CLASSES, size=bsz)))
    return out


def test_five_micro_steps_with_accumulation_and_freezing_match_jax(monkeypatch):
    """setup_mmbt in both packages from the same weights: five micro-steps
    with accumulation 2 on uint8 images, the freeze flags switching between
    steps. Per-step losses within 1e-5 relative; after the five steps the
    parameters, BatchNorm running statistics, BertAdam moments and steps, the
    accumulated gradients of step 5 and the micro-step count equal the JAX
    state's within 1e-5.

    Both run with float64 weights (JAX under ``jax.enable_x64``): in fp32 a
    ReLU input within rounding of 0 lands on either side of the kink in the
    two packages and flips a whole BatchNorm channel's gradient (at this
    seed JAX's conv1 gradient is 2.7e-3 off an fp64 run, the port's 3.6e-6),
    which BertAdam's first, sign-like step turns into differences of ~lr.
    The ResNet then runs in fp64 on both sides; BERT's attention, LayerNorm
    and loss stay fp32 inside on both, so its half is compared at fp32
    rounding. The fp32 pieces are held to JAX one by one above and in
    ``test_torch_mmbt.py``."""
    kw = dict(n_classes=N_CLASSES, lr=5e-5, warmup=0.0, total_steps=10.0, resnet_layers=RESNET,
              dropout=0.0, gradient_accumulation_steps=2)
    variables = _tiny_variables()
    flags = [(True, True), (True, False), (False, False), (False, True), (False, False)]
    def init_state(model, optimizer, sample_x, key, *, accum):
        """The JAX setup's state, from the shared weights in float64 (its own
        init draws weights that would be replaced)."""
        params, stats = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                                variables[k]) for k in ("params", "batch_stats"))
        return TrainState(params=params, opt_state=optimizer.init(params), batch_stats=stats,
                          step=jnp.zeros((), jnp.int32),
                          accum_grads=jax.tree_util.tree_map(jnp.zeros_like, params))

    monkeypatch.setattr(jax_zoo, "_init_state", init_state)
    with jax.enable_x64(True):
        js = jax_setup_mmbt(**kw, bert_config=JB.BertConfig(**BERT), image_size=IMG,
                            seed_key=jax.random.key(0), attn_impl="xla")
        state = js.state
        jstep = build_train_step(js.bundle, js.optimizer, gradient_accumulation_steps=2,
                                 donate=False)
        ts = setup_mmbt(**kw, bert_config=TB.BertConfig(**BERT), device="cpu")
        ts.model.load_state_dict(mmbt_state_dict_from_jax(variables), strict=True)
        ts.model.double()
        ts = dataclasses.replace(
            ts, optimizer=optim.BertAdam(ts.model.named_parameters(), 5e-5, 0.0, 10.0),
            accumulator=GradAccumulator(2, ts.model.named_parameters()))
        for i, (batch, fl) in enumerate(zip(_batches(5, 3), flags), start=1):
            x, y = batch
            state, jlogs = jstep(state, tuple(jnp.asarray(a) for a in x), jnp.asarray(y),
                                 jax.random.key(i), jnp.asarray(fl))
            tx, ty = to_device(batch, "cpu")
            tlogs = train_step(ts.bundle, ts.optimizer, tx, ty,
                               torch.Generator().manual_seed(i), flags=fl,
                               accumulator=ts.accumulator)
            np.testing.assert_allclose(float(tlogs["loss"]), float(jlogs["loss"]), rtol=1e-5,
                                       err_msg=f"loss at micro-step {i}")
            assert float(tlogs["acc"]) == pytest.approx(float(jlogs["acc"]), abs=1e-4)
        assert ts.step == int(state.step) == 5
        state = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), state)

    def port_names(tree):
        return mmbt_state_dict_from_jax({"params": tree})

    noise_bound = 2 * sum(ts.optimizer.schedule(t) for t in range(3))
    want = mmbt_state_dict_from_jax({"params": state.params, "batch_stats": state.batch_stats})
    for name, t in ts.model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = t.numpy(), want[name].numpy()
        if name.endswith("attention.self.key.bias"):
            # true gradient 0: each package's rounding noise, bounded by 2 sum(lr_t)
            assert np.abs(got - ref).max() <= noise_bound, name
            continue
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=name)
    assert int(ts.model.enc.img_encoder.model.bn1.num_batches_tracked) == 5
    for key, own, ref in (("mu", ts.optimizer.mu, state.opt_state["mu"]),
                          ("nu", ts.optimizer.nu, state.opt_state["nu"]),
                          ("accumulated", ts.accumulator.grads, state.accum_grads)):
        ref = port_names(ref)
        for name, t in own.items():
            if not name.endswith("attention.self.key.bias"):
                np.testing.assert_allclose(t.numpy(), ref[name].numpy(), atol=1e-5, rtol=1e-5,
                                           err_msg=f"{key} {name}")
    assert ts.optimizer.steps == {n: int(t) for n, t in
                                  port_names(state.opt_state["step"]).items()}
    assert ts.optimizer.steps["clf.weight"] == 2
    assert ts.optimizer.steps["enc.img_encoder.model.conv1.weight"] == 1  # frozen at step 2
    assert ts.optimizer.steps["enc.encoder.layer.0.output.dense.weight"] == 1  # frozen at 4


def test_frozen_subtrees_stay_bit_unchanged_and_skip_their_backward():
    ts = setup_mmbt(n_classes=N_CLASSES, bert_config=TB.BertConfig(**BERT), resnet_layers=RESNET,
                    gradient_accumulation_steps=1, lr=1e-3, warmup=0.0, device="cpu")
    before = {n: p.detach().clone() for n, p in ts.model.named_parameters()}
    stats = ts.model.enc.img_encoder.model.bn1.running_mean.clone()
    x, y = to_device(_batches(1, 4)[0], "cpu")
    train_step(ts.bundle, ts.optimizer, x, y, flags=(True, True), accumulator=ts.accumulator)
    for name, p in ts.model.named_parameters():
        same = torch.equal(p.detach(), before[name])
        frozen = name.startswith(("enc.img_encoder.", "enc.encoder."))
        assert same == frozen, name
        assert p.requires_grad != frozen and p.grad is None
    assert not torch.equal(ts.model.enc.img_encoder.model.bn1.running_mean, stats)  # BN still moves


# ---------------------------------------------------------------- data


def _write_tree(root, rng, *, n=(10, 4, 4), labels=("pho", "ramen", "tacos")):
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    words = ["the", "soup", "is", "very", "good", "##s", "noodle", "broth", "spicy", "taco",
             "shell", "ramen", "pho", "bowl", "!", ",", "un", "##able"]
    special = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                                  "[MASK]"]  # BERT's ids
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(special + words) + "\n")
    from PIL import Image
    for split, count in zip(("train", "dev", "test"), n):
        with open(os.path.join(root, f"{split}.jsonl"), "w") as f:
            for i in range(count):
                text = " ".join(rng.choice(words[:15] + ["Phở", "SOUPS", "zzz"],
                                           size=int(rng.integers(2, 30))))
                if i % 2:
                    name = f"images/{split}_{i}.ppm"
                    images.write_ppm(os.path.join(root, name),
                                     rng.integers(0, 256, (256, 256, 3), dtype=np.uint8))
                else:
                    name = f"images/{split}_{i}.jpg"
                    size = (int(rng.integers(200, 400)), int(rng.integers(200, 400)))
                    Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)).save(
                        os.path.join(root, name))
                f.write(json.dumps({"id": i, "label": labels[i % len(labels)], "text": text,
                                    "img": name}) + "\n")


def test_jsonl_rows_and_collate_match_jax(tmp_path):
    """Rows (token ids, token types, cropped image, label) and collated
    batches equal the JAX package's on a tree of JPEGs (resized by PIL) and
    256x256 P6 images, drop_img_percent 0.5 included; the loaders' batches
    equal JAX ``get_food101``'s (its native tokenizer gives the same ids)."""
    root = str(tmp_path)
    _write_tree(root, np.random.default_rng(5))
    vocab_file = os.path.join(root, "vocab.txt")
    labels, freqs = food101.get_labels_and_frequencies(os.path.join(root, "train.jsonl"))
    assert (labels, freqs) == jax_food.get_labels_and_frequencies(os.path.join(root, "train.jsonl"))
    port = food101.JsonlDataset(os.path.join(root, "train.jsonl"),
                                BertTokenizer(vocab_file).tokenize, get_vocab(vocab_file),
                                len(labels), 0.5, 20, 3, labels)
    ref = jax_food.JsonlDataset(os.path.join(root, "train.jsonl"),
                                JaxTokenizer(vocab_file).tokenize, jax_get_vocab(vocab_file),
                                len(labels), 0.5, 20, 3, labels)
    rows = []
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        assert got[3] == want[3] and got[2].shape == (224, 224, 3)
        rows.append(got)
    assert any(r[0].size == 20 - 3 - 1 for r in rows)  # a text was cut
    assert any(d["img"] is None for d in port.data)  # drop_img replaced an image
    for a, b in zip(food101.collate_fn(rows[:5]), jax_food.collate_fn([ref[i] for i in range(5)])):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)
    assert food101.collate_fn(rows[:5])[0][0].shape[1] % 32 == 0

    tl = food101.get_food101(datapath=root, batch_size=4, n_workers=0, seed=3, max_seq_len=30)
    jl = jax_food.get_food101(datapath=root, batch_size=4, n_workers=0, seed=3, max_seq_len=30)
    assert tl[3] == jl[3] and tl[4].vocab_sz == jl[4].vocab_sz
    for tload, jload in zip(tl[:3], jl[:3]):
        assert len(tload) == len(jload)
        for tb, jb in zip(tload.iter_epoch(2), jload.iter_epoch(2)):
            for a, b in zip((*tb[0], tb[1]), (*jb[0], jb[1])):
                np.testing.assert_array_equal(a, b)


def test_p6_reader_and_crop_match_pil(tmp_path, monkeypatch):
    from PIL import Image

    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (280, 300, 3), dtype=np.uint8)
    path = str(tmp_path / "a.ppm")
    with open(path, "wb") as f:  # a comment in the header, as some writers add
        f.write(b"P6\n# made by a test\n300 280\n255\n" + img.tobytes())
    np.testing.assert_array_equal(images.read_ppm(path), img)
    np.testing.assert_array_equal(images.read_ppm(path), np.asarray(Image.open(path)))
    square = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    images.write_ppm(str(tmp_path / "b.ppm"), square)
    want = jax_images.resize_center_crop(jax_images.decode_rgb(str(tmp_path / "b.ppm")))
    np.testing.assert_array_equal(images.resize_center_crop(images.decode_rgb(
        str(tmp_path / "b.ppm"))), want)
    monkeypatch.setattr(images, "_pil_image", lambda: None)  # the card's host: no PIL
    got = images.decode_rgb(str(tmp_path / "b.ppm"))
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(images.resize_center_crop(got), want)
    with pytest.raises(RuntimeError, match="needs PIL"):
        images.resize_center_crop(img)  # 280 high: a resize to 256 is needed
    Image.fromarray(square).save(str(tmp_path / "c.png"))
    with pytest.raises(ValueError, match="P6"):
        images.decode_rgb(str(tmp_path / "c.png"))
    x = rng.integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)
    np.testing.assert_allclose(
        images.normalize_on_device(torch.from_numpy(x), images.FOOD101_MEAN,
                                   images.FOOD101_STD).numpy(),
        np.asarray(jax_images.normalize_on_device(jnp.asarray(x), jax_images.FOOD101_MEAN,
                                                  jax_images.FOOD101_STD)), atol=1e-6)


# ---------------------------------------------------------------- the CLI


def _cli(tmp_path, *extra):
    return ["--framework", "mmbt", "--dataset", "food101", "--tiny", "--device", "cpu",
            "--save_path", str(tmp_path / "run"), "--batch_size", "4",
            "--gradient_accumulation_steps", "2", "--freeze_img", "2", "--freeze_txt", "2",
            "--lr", "1e-4", *extra]


def test_mmbt_train_cli_on_the_cpu_history_checkpoints_resume(tmp_path, monkeypatch):
    """``--tiny --device cpu`` for 2 epochs (the image and text encoders
    frozen in epoch 1): history.csv, the checkpoints with the accumulated
    gradients, the plateau state and BertAdam's per-parameter steps; the
    frozen ResNet is unchanged after epoch 1; a resume reproduces the last
    val metrics; ``--resume`` continues to epoch 3."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    _write_tree(str(tmp_path / "data" / "food101"), np.random.default_rng(7))
    trainer = port_train.main(_cli(tmp_path, "--n_epochs", "2", "--attention_probs_dropout",
                                   "0.1"))
    run = tmp_path / "run"
    hist = load_history(str(run))
    assert hist["epoch"] == [1, 2] and np.isfinite(hist["loss"]).all()
    assert {"history.csv", "model_best_val.pt", "model_epoch_1.pt", "model_epoch_2.pt",
            "model_last_epoch.pt"} <= set(os.listdir(run))
    first, _ = load_weights(str(run / "model_epoch_1.pt"))
    model_sd, opt = load_weights(str(run / "model_last_epoch.pt"))
    init = setup_mmbt(n_classes=3, bert_config=dataclasses.replace(
        TB.BertConfig.base(), hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=128, vocab_size=122), resnet_layers=RESNET, seed=42, device="cpu")
    for name, t in init.model.state_dict().items():
        if name.startswith("enc.img_encoder.") and "running" not in name and "tracked" not in name:
            assert torch.equal(first[name], t), name  # frozen through epoch 1
    assert int(opt["step"]) == 2 * 3 and set(opt["accum_grads"]) == set(opt["opt_state"]["mu"])
    assert set(opt["scheduler"]) == {"scale", "best", "num_bad_epochs", "cooldown_counter"}
    steps = opt["opt_state"]["step"]
    assert int(steps["clf.weight"]) == 3 and int(steps["enc.encoder.layer.0.output.dense.weight"]) == 2

    resume_train_state(init.model, init.optimizer, str(run / "model_last_epoch.pt"),
                       accumulator=init.accumulator, plateau=init.plateau)
    assert init.optimizer.steps == trainer.optimizer.steps and init.accumulator.step == 6
    _, valid, _, _, _ = food101.get_food101(datapath=str(tmp_path / "data" / "food101"),
                                            batch_size=4, n_workers=0, seed=42)
    again = Trainer(init.bundle, init.optimizer, seed=42, verbose=False).eval_loop(valid, "val")
    assert again["val_loss"] == pytest.approx(hist["val_loss"][-1], rel=1e-6)
    assert again["val_acc"] == pytest.approx(hist["val_acc"][-1], abs=1e-6)

    port_train.main(_cli(tmp_path, "--n_epochs", "3", "--resume"))
    assert load_history(str(run))["epoch"] == [1, 2, 3]


@pytest.mark.parametrize("flag", [
    ["--fast_decode"], ["--batch_decode"], ["--fsdp"],
    ["--ckpt_backend", "orbax"],
])
def test_mmbt_cli_rejects_what_is_not_ported(tmp_path, flag, capsys):
    with pytest.raises(SystemExit):
        port_train.main(_cli(tmp_path) + flag)
    assert "ported to PyTorch yet" in capsys.readouterr().err


def test_mmbt_cli_takes_bf16_and_builds_mmbt_in_bf16(tmp_path, monkeypatch):
    """``--bf16`` (rejected until the bf16 slice) sets MMBT's compute dtype to
    bf16, as the root CLI's ``dtype=jnp.bfloat16``: the ResNet and BERT run in
    it (bf16 logits on a loader batch), parameters and BatchNorm statistics
    stay fp32 (``tests/test_torch_bf16.py`` trains it)."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    _write_tree(str(tmp_path / "data" / "food101"), np.random.default_rng(3))
    args = port_train.add_conditional_args(
        port_train.build_parser().parse_args(_cli(tmp_path, "--bf16")))
    train, _, _, setup = port_train._mmbt_setup(args, torch.device("cpu"))
    model = setup.model
    assert model.enc.dtype == model.enc.img_encoder.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in model.state_dict().values()
               if t.is_floating_point())
    x, _ = to_device(next(iter(train)), "cpu")
    with torch.inference_mode():
        model.eval()
        assert setup.bundle.apply_fn(model, x, train=False).dtype == torch.bfloat16


def test_mmbt_cli_needs_food101(tmp_path, capsys):
    argv = _cli(tmp_path)
    argv[argv.index("food101")] = "hateful-meme-dataset"
    with pytest.raises(SystemExit):
        port_train.main(argv)
    assert "food101" in capsys.readouterr().err
