"""``--remat`` in the port against the JAX package's ``remat=True``, and
against the port without it, on the CPU.

A rematerialised block keeps only its inputs and runs its forward again in
the backward (``models/remat.py``). That second forward must compute what the
first did: the same attention-probability keep mask (drawn from an explicit
generator, which torch's checkpoint does not restore), the same ``nn.Dropout``
masks, and BatchNorm's running statistics updated once.

Tolerances: remat against no remat in the port exactly for the losses and
gradients of the fusion model, BERT and MMBT, and the BatchNorm statistics
(the same CPU kernels on the same inputs); the port against JAX within 1e-5
(fp32 summed in another order) for fusion and BERT, the key biases (true
gradient 0) aside; MMBT against JAX in float64 (JAX under
``jax.enable_x64``: in fp32 a ReLU input within rounding of 0 flips a
BatchNorm channel's gradient, ``tests/test_torch_mmbt_training.py``), within
1e-6 x max(1, max|ref|).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.models import bert as JB
from multimodal_uncertainty_tpu.models.mmbt import MultimodalBertClf as JaxMMBT
from multimodal_uncertainty_tpu.models.fusion import FlavaFusionTransformer as JaxFusion
from multimodal_uncertainty_tpu_torch import train as port_train
from multimodal_uncertainty_tpu_torch.models import bert as TB
from multimodal_uncertainty_tpu_torch.models import remat as R
from multimodal_uncertainty_tpu_torch.models.jax_import import (
    fusion_state_dict_from_jax,
    mmbt_state_dict_from_jax,
)
from multimodal_uncertainty_tpu_torch.models.fusion import FlavaFusionTransformer
from multimodal_uncertainty_tpu_torch.models.mmbt import MultimodalBertClf
from multimodal_uncertainty_tpu_torch.ops import attention as A
from multimodal_uncertainty_tpu_torch.ops.losses import mimo_cross_entropy
from multimodal_uncertainty_tpu_torch.zoo import setup_flava, setup_mmbt

BERT = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128, max_position_embeddings=64)
N_CLASSES, RESNET, IMG = 5, (1, 1, 1, 1), 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several test processes share a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree, dtype=np.float32):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype), tree)


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _assert_close(got: dict, want: dict, rel: float, skip=()):
    assert set(got) == set(want)
    for name, g in got.items():
        g, ref = np.asarray(g, np.float64), np.asarray(want[name], np.float64)
        if any(name.endswith(s) for s in skip):
            continue
        np.testing.assert_allclose(g, ref, atol=rel * max(1.0, float(np.abs(ref).max())),
                                   rtol=0, err_msg=name)


# ---------------------------------------------------------------- fusion


FUSION = dict(out_dim=2, num_classes=3, image_hidden_size=16, text_hidden_size=16,
              multimodal_hidden_size=64, multimodal_num_attention_heads=2,
              multimodal_num_hidden_layers=2)


def _fusion_batch(seed=0, b=4, d=16):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, 7, d)).astype(np.float32)
    txt = rng.normal(size=(b, 5, d)).astype(np.float32)
    img_mask = np.ones((b, 7), bool)
    txt_mask = np.arange(5)[None] < rng.integers(2, 6, size=b)[:, None]
    y = rng.integers(0, 3, size=(b, 2))
    return img, txt, img_mask, txt_mask, y


@functools.lru_cache(maxsize=None)
def _jax_fusion_params():
    img, txt, *_ = _fusion_batch()
    model = JaxFusion(**FUSION, attn_impl="xla")
    init = jax.jit(functools.partial(model.init, train=False))
    return _np(init({"params": jax.random.key(0)}, (jnp.asarray(img), jnp.asarray(txt)))["params"])


def _port_fusion_grads(remat: bool, drop: float = 0.0, seed: int = 0):
    model = FlavaFusionTransformer(**FUSION, drop=drop, remat=remat)
    model.load_state_dict(fusion_state_dict_from_jax(_jax_fusion_params()))
    img, txt, img_mask, txt_mask, y = _fusion_batch()
    torch.manual_seed(seed)  # the encoder's nn.Dropout draws from the default generator
    logits = model.train()((torch.from_numpy(img), torch.from_numpy(txt)),
                           img_mask=torch.from_numpy(img_mask),
                           txt_mask=torch.from_numpy(txt_mask))
    loss = mimo_cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    return float(loss.detach()), _grads(model)


def test_fusion_remat_equals_no_remat_and_the_jax_remat_model():
    """The fusion encoder rematerialised: loss and every gradient equal the
    port's without remat bit for bit, with encoder dropout 0.2 too (the
    checkpoint puts the default generator back for the recompute); and equal
    JAX's ``remat=True`` model within 1e-5."""
    loss, grads = _port_fusion_grads(True)
    loss0, grads0 = _port_fusion_grads(False)
    assert loss == loss0
    _assert_close(grads, grads0, 0.0)
    dloss, dgrads = _port_fusion_grads(True, drop=0.2, seed=3)
    dloss0, dgrads0 = _port_fusion_grads(False, drop=0.2, seed=3)
    assert dloss == dloss0 and dloss != loss
    _assert_close(dgrads, dgrads0, 0.0)

    model = JaxFusion(**FUSION, attn_impl="xla", remat=True)
    img, txt, img_mask, txt_mask, y = _fusion_batch()

    def jloss(params):
        logits = model.apply({"params": params}, (jnp.asarray(img), jnp.asarray(txt)),
                             train=True, img_mask=jnp.asarray(img_mask),
                             txt_mask=jnp.asarray(txt_mask))
        return model.compute_loss(logits, jnp.asarray(y))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(_jax_fusion_params())
    assert loss == pytest.approx(float(ref_loss), rel=1e-5)
    _assert_close(grads, fusion_state_dict_from_jax(_np(ref_grads)), 1e-5,
                  skip=("attn.in_proj.bias",))


# ---------------------------------------------------------------- BERT


def _bert_inputs(seed=1, b=3, s=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, BERT["hidden_size"])).astype(np.float32)
    mask = np.arange(s)[None] < np.array([s, 9, 5])[:, None]
    return x, mask


def _port_bert(cfg, remat: bool, params):
    enc = TB.BertEncoder(cfg, remat=remat)
    enc.load_state_dict(mmbt_state_dict_from_jax({"params": _np(params)}), strict=True)
    return enc.train()


@functools.lru_cache(maxsize=None)
def _jax_bert_params():
    x, mask = _bert_inputs()
    enc = JB.BertEncoder(JB.BertConfig(**BERT), "xla")
    init = jax.jit(functools.partial(enc.init, train=False))
    return init(jax.random.key(4), jnp.asarray(x), jnp.asarray(mask))["params"]


def _bert_step(cfg, remat: bool, gen_seed: int = 7):
    enc = _port_bert(cfg, remat, _jax_bert_params())
    x, mask = _bert_inputs()
    xt = torch.from_numpy(x).requires_grad_()
    torch.manual_seed(11)
    gen = torch.Generator().manual_seed(gen_seed)
    out = enc(xt, torch.from_numpy(mask), gen)
    (out * torch.linspace(-1, 1, out.shape[-1])).sum().backward()
    return out.detach(), {**_grads(enc), "x": xt.grad.clone()}


def test_bert_remat_with_attention_dropout_draws_the_same_keep_mask(monkeypatch):
    """BERT with attention-probability dropout 0.3 (K5's path) and hidden
    dropout 0.1, its keep masks drawn from an explicit generator: every
    layer's recompute draws the keep mask its forward drew, so the outputs
    and gradients equal those without remat bit for bit. Without the
    generator's state put back (the checkpoint alone) the recompute draws new
    masks and the gradients differ: the check has teeth."""
    cfg = TB.BertConfig(**{**BERT, "attention_probs_dropout_prob": 0.3,
                           "hidden_dropout_prob": 0.1})
    drawn = []
    real_draw = A.draw_keep_mask
    monkeypatch.setattr(A, "draw_keep_mask",
                        lambda *a, **kw: drawn.append(real_draw(*a, **kw)) or drawn[-1])
    out, grads = _bert_step(cfg, remat=True)
    layers = BERT["num_hidden_layers"]
    assert len(drawn) == 2 * layers  # each layer's forward, then its recompute (last first)
    for i in range(layers):
        assert torch.equal(drawn[i], drawn[2 * layers - 1 - i]), f"layer {i}"
        assert not bool(drawn[i].all())
    out0, grads0 = _bert_step(cfg, remat=False)
    assert torch.equal(out, out0)
    _assert_close(grads, grads0, 0.0)

    real_remat = R.remat
    monkeypatch.setattr(TB, "remat", lambda fn, *args, generator=None: real_remat(fn, *args))
    drawn.clear()
    _, bad = _bert_step(cfg, remat=True)
    assert not torch.equal(drawn[0], drawn[-1])
    assert any(not torch.equal(bad[n], grads0[n]) for n in grads0)


def test_bert_remat_matches_the_jax_remat_encoder():
    """2 BERT layers without dropout: the port's rematerialised encoder
    against JAX's ``BertEncoder(remat=True)``: outputs and gradients within
    1e-5 (the key biases, true gradient 0, aside)."""
    x, mask = _bert_inputs()
    jenc = JB.BertEncoder(JB.BertConfig(**{**BERT, "hidden_dropout_prob": 0.0}), "xla",
                          remat=True)
    params = _jax_bert_params()
    w = jnp.linspace(-1, 1, BERT["hidden_size"])

    def jloss(p, xx):
        out = jenc.apply({"params": p}, xx, jnp.asarray(mask), train=True)
        return (out * w).sum(), out

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    cfg = TB.BertConfig(**{**BERT, "hidden_dropout_prob": 0.0})
    out, grads = _bert_step(cfg, remat=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    want = {**mmbt_state_dict_from_jax({"params": _np(gp)}), "x": np.asarray(gx)}
    _assert_close(grads, want, 1e-5, skip=("attention.self.key.bias",))


# ---------------------------------------------------------------- MMBT


def _mmbt_inputs(seed=2, b=4, lt=10):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, lt + 1, size=b)
    mask = (np.arange(lt)[None] < lengths[:, None]).astype(np.int64)
    txt = rng.integers(104, BERT["vocab_size"], size=(b, lt)) * mask
    seg = rng.integers(0, 2, size=(b, lt)) * mask
    img = rng.normal(size=(b, IMG, IMG, 3))
    return txt, mask, seg, img, rng.integers(0, N_CLASSES, size=b)


@functools.lru_cache(maxsize=None)
def _jax_mmbt_variables():
    model = JaxMMBT(config=JB.BertConfig(**BERT), n_classes=N_CLASSES, resnet_layers=RESNET,
                    dropout=0.0, attn_impl="xla")
    txt, mask, seg, img, _ = _mmbt_inputs()
    x = (jnp.asarray(txt), jnp.asarray(mask), jnp.asarray(seg), jnp.asarray(img, jnp.float32))
    variables = jax.jit(functools.partial(model.init, train=False))({"params": jax.random.key(3)},
                                                                    x)
    return _np(variables, np.float64)


def _port_mmbt_step(remat: bool, *, cfg=None, dtype=torch.float64, flags=(False, False),
                    dropout_gen=None):
    """One training forward and backward of the tiny MMBT from the JAX
    weights; returns (loss, grads, BatchNorm running statistics)."""
    cfg = cfg or TB.BertConfig(**{**BERT, "hidden_dropout_prob": 0.0})
    model = MultimodalBertClf(cfg, N_CLASSES, 3, dropout=0.0, resnet_layers=RESNET, remat=remat)
    model.load_state_dict(mmbt_state_dict_from_jax(_jax_mmbt_variables()), strict=True)
    model.to(dtype).train()
    for name, p in model.named_parameters():
        p.requires_grad_(not name.startswith(tuple(
            prefix + "." for prefix, frozen in zip(("enc.img_encoder", "enc.encoder"), flags)
            if frozen)))
    txt, mask, seg, img, y = _mmbt_inputs()
    x = (torch.from_numpy(txt), torch.from_numpy(mask), torch.from_numpy(seg),
         torch.from_numpy(img).to(dtype))
    torch.manual_seed(5)
    logits = model(x, dropout_generator=dropout_gen)
    loss = model.compute_loss(logits.float(), torch.from_numpy(y))
    loss.backward()
    stats = {n: t.clone() for n, t in model.state_dict().items() if "running" in n}
    return float(loss.detach()), _grads(model), stats


@pytest.mark.parametrize("flags", [(False, False), (True, True)])
def test_mmbt_remat_equals_no_remat_batchnorm_statistics_included(flags):
    """Every ResNet bottleneck and BERT layer rematerialised (fp32, attention
    dropout 0.2 through an explicit generator): the loss, the gradients and
    the BatchNorm running statistics after the step equal those without
    remat bit for bit (the statistics move once, not twice). With both
    encoders frozen (MMBT's epoch 1) the gradients still reach what the
    frozen BERT layers take their input from."""
    cfg = TB.BertConfig(**{**BERT, "attention_probs_dropout_prob": 0.2})
    runs = [_port_mmbt_step(remat, cfg=cfg, dtype=torch.float32, flags=flags,
                            dropout_gen=torch.Generator().manual_seed(9))
            for remat in (True, False)]
    (loss, grads, stats), (loss0, grads0, stats0) = runs
    assert loss == loss0
    _assert_close(grads, grads0, 0.0)
    assert set(stats) == set(stats0)
    for name in stats:
        assert torch.equal(stats[name], stats0[name]), name
    initial = mmbt_state_dict_from_jax(_jax_mmbt_variables())
    assert not torch.equal(stats["enc.img_encoder.model.bn1.running_mean"],
                           initial["enc.img_encoder.model.bn1.running_mean"].float())
    if flags == (True, True):
        assert not any(n.startswith(("enc.img_encoder.", "enc.encoder.")) for n in grads)
        assert float(grads["enc.txt_embeddings.word_embeddings.weight"].abs().max()) > 0


def test_mmbt_remat_matches_the_jax_remat_model_in_float64():
    """The tiny MMBT (ResNet (1, 1, 1, 1) at 32 x 32, 2 BERT layers) with
    remat against JAX's ``remat=True`` model, both in float64: the loss,
    every gradient and the BatchNorm statistics after the step within 1e-6 x
    max(1, max|ref|)."""
    txt, mask, seg, img, y = _mmbt_inputs()
    with jax.enable_x64(True):
        model = JaxMMBT(config=JB.BertConfig(**{**BERT, "hidden_dropout_prob": 0.0}),
                        n_classes=N_CLASSES, resnet_layers=RESNET, dropout=0.0,
                        attn_impl="xla", remat=True)
        variables = jax.tree_util.tree_map(jnp.asarray, _jax_mmbt_variables())
        x = (jnp.asarray(txt), jnp.asarray(mask), jnp.asarray(seg), jnp.asarray(img))

        def jloss(params):
            logits, mutated = model.apply({"params": params,
                                           "batch_stats": variables["batch_stats"]},
                                          x, train=True, mutable=["batch_stats"])
            return model.compute_loss(logits.astype(jnp.float32), jnp.asarray(y)), mutated

        (ref_loss, mutated), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            variables["params"])
        ref_grads = _np(ref_grads, np.float64)
        ref_stats = mmbt_state_dict_from_jax({"params": _np(variables["params"], np.float64),
                                              "batch_stats": _np(mutated["batch_stats"],
                                                                 np.float64)})
    loss, grads, stats = _port_mmbt_step(True)
    assert loss == pytest.approx(float(ref_loss), rel=1e-6)
    _assert_close(grads, mmbt_state_dict_from_jax({"params": ref_grads}), 1e-6,
                  skip=("attention.self.key.bias",))
    _assert_close({n: t for n, t in stats.items()},
                  {n: ref_stats[n] for n in stats}, 1e-6)


# ---------------------------------------------------------------- setups and CLI


def test_setups_build_rematerialised_models():
    ts = setup_flava(multimodal_num_hidden_layers=1, remat=True, device="cpu")
    assert ts.model.mm_encoder.remat
    tm = setup_mmbt(n_classes=3, bert_config=TB.BertConfig(**BERT), resnet_layers=RESNET,
                    remat=True, device="cpu")
    assert tm.model.enc.encoder.remat and tm.model.enc.img_encoder.model.remat
    assert not setup_flava(multimodal_num_hidden_layers=1, device="cpu").model.mm_encoder.remat


def test_remat_leaves_eval_and_inference_alone(monkeypatch):
    """Eval and serving run the blocks plainly: no checkpoint outside grad mode."""
    calls = []
    monkeypatch.setattr(R, "checkpoint", lambda *a, **kw: calls.append(1))
    ts = setup_flava(multimodal_num_hidden_layers=1, image_hidden_size=8, text_hidden_size=8,
                     remat=True, device="cpu")
    with torch.inference_mode():
        ts.model.eval()((torch.randn(2, 3, 8), torch.randn(2, 4, 8)))
    assert calls == []


def test_train_cli_takes_remat_for_flava_and_mmbt(tmp_path, monkeypatch):
    monkeypatch.setenv("DATA_DIR", str(tmp_path))
    for framework, extra in (("flava", []), ("mmbt", ["--dataset", "food101", "--tiny"])):
        args = port_train.build_parser().parse_args(
            ["--framework", framework, "--save_path", str(tmp_path / framework), "--remat",
             "--device", "cpu", *extra])
        assert args.remat
    args = port_train.add_conditional_args(port_train.build_parser().parse_args(
        ["--framework", "flava", "--save_path", str(tmp_path / "f"), "--remat", "--device",
         "cpu", "--multimodal_num_hidden_layers", "1"]))
    import multimodal_uncertainty_tpu_torch.data.flava_encoded as FE

    monkeypatch.setattr(FE, "get_dataset_flava", lambda args, path: ([0], [0], [0]))
    _, _, _, setup = port_train._flava_setup(args, torch.device("cpu"))
    assert setup.model.mm_encoder.remat


def test_remat_helper_restores_the_generator_and_marks_the_recompute():
    """``remat`` leaves an explicit generator where the forward left it, and
    ``recomputing()`` is True only inside the backward's second forward."""
    seen = []
    gen = torch.Generator().manual_seed(1)

    def block(x):
        seen.append(R.recomputing())
        return x * torch.rand(x.shape, generator=gen)

    x = torch.ones(4, requires_grad=True)
    y = R.remat(block, x, generator=gen)
    after_forward = gen.get_state()
    y.sum().backward()
    assert seen == [False, True] and not R.recomputing()
    assert torch.equal(gen.get_state(), after_forward)
    assert torch.equal(x.grad, y.detach())  # the recompute drew the forward's noise
