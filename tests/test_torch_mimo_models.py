"""The FashionMNIST round's models and optimizers in the port against the JAX
package's, on the CPU: ``MultiHeadFC`` and ``BasicBlock`` inside the MIMO
ResNet, the MIMO transformer (its attention on K1 at S = 4), SGD and
BertAdam, with the weights carried across by the new converters
(``mimo_resnet_state_dict_from_jax``, ``mimo_transformer_state_dict_from_jax``)
and inputs drawn with numpy from a seed.

Tolerances: logits 1e-5 absolute (fp32 summed in another order); one step's
gradients 1e-4 x the leaf's max |gradient| (fp32 sums over the batch);
BatchNorm's running statistics 1e-6 + 2e-6 relative (fp32 rounding of values
near 1). Five SGD steps with BatchNorm in training
mode run in float64 on both sides (JAX under ``jax.enable_x64``: in fp32 a
ReLU input within rounding of 0 flips a gradient, which momentum carries),
held to 1e-6: the loss's log-softmax is fp32 in both packages, so the
gradients carry fp32 rounding. Five BertAdam steps of the transformer in fp32: losses 1e-5
relative, parameters and moments 1e-5, except the key bias columns of each
``in_proj``, whose true gradient is 0: within 2 x the sum of the learning
rates (ROADMAP's "Key biases").
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu import zoo as jax_zoo
from multimodal_uncertainty_tpu.models.mimo_resnet import MIMOResNet as JaxResNet
from multimodal_uncertainty_tpu.models.mimo_transformer import MIMOTransformer as JaxTransformer
from multimodal_uncertainty_tpu.ops import attention as JA
from multimodal_uncertainty_tpu.training.state import TrainState
from multimodal_uncertainty_tpu.training.steps import build_train_step
from multimodal_uncertainty_tpu_torch.models import mimo_transformer
from multimodal_uncertainty_tpu_torch.models.jax_import import (
    mimo_resnet_state_dict_from_jax,
    mimo_transformer_state_dict_from_jax,
)
from multimodal_uncertainty_tpu_torch.models.mimo_resnet import MIMOResNet
from multimodal_uncertainty_tpu_torch.models.mimo_transformer import MIMOTransformer
from multimodal_uncertainty_tpu_torch.ops import data_forming
from multimodal_uncertainty_tpu_torch.training import optim
from multimodal_uncertainty_tpu_torch.training.steps import train_step
from multimodal_uncertainty_tpu_torch.zoo import setup_fashionmnist


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the test run puts several processes on
    a few cores at once, and torch's CPU convolutions spinning on every core
    from each of them slow to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _resnet_variables(model, x, seed):
    """JAX init, with BatchNorm's scales, biases and running statistics
    redrawn from a numpy seed (so eval mode differs from training)."""
    variables = _np(model.init({"params": jax.random.key(seed)}, jnp.asarray(x), train=False))
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean",) or (name == "bias" and path[-2].key == "bn"):
            return rng.normal(0, 0.2, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(redraw, variables)


def _grads_of(model):
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def _assert_grads(got: dict, want: dict, rtol=1e-4, skip_key_bias=False):
    assert set(got) == set(want)
    for name, g in got.items():
        ref = want[name].numpy()
        if skip_key_bias and name.endswith("attn.in_proj.bias"):
            d = ref.shape[0] // 3
            g, ref = np.delete(g, np.s_[d:2 * d]), np.delete(ref, np.s_[d:2 * d])
        tol = rtol * max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(g, ref, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("model_type,emb,out,shape", [
    ("MIMO-shuffle-instance", 4, 4, (6, 4, 1, 14, 14)),
    ("Vanilla", 4, 1, (6, 4, 1, 14, 14)),
    ("single-model-weight-sharing", 1, 1, (12, 1, 14, 14)),
])
def test_mimo_resnet_matches_jax_in_eval_and_training_mode(model_type, emb, out, shape):
    """Logits in eval mode (running statistics) and in training mode (batch
    statistics), the running statistics training mode leaves, and the
    gradients of the training-mode MIMO loss."""
    rng = np.random.default_rng(len(shape) + out)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = rng.integers(0, 10, (shape[0], out) if out > 1 else (shape[0], 1))
    jmodel = JaxResNet(num_channels=1, emb_dim=emb, out_dim=out, num_classes=10)
    variables = _resnet_variables(jmodel, x, seed=out)
    model = MIMOResNet(num_channels=1, emb_dim=emb, out_dim=out, num_classes=10)
    model.load_state_dict(mimo_resnet_state_dict_from_jax(variables), strict=True)

    ref_eval = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got_eval = model.eval()(torch.from_numpy(x)).numpy()
    assert got_eval.shape == (shape[0], out, 10)
    np.testing.assert_allclose(got_eval, ref_eval, atol=1e-5, rtol=0)

    def jloss(params):
        logits, mutated = jmodel.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
        return JaxResNet.compute_loss(logits, jnp.asarray(y)), (logits, mutated)

    (_, (ref_train, mutated)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    model.train()
    logits = model(torch.from_numpy(x))
    model.compute_loss(logits, torch.from_numpy(y)).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_train), atol=1e-5, rtol=0)
    want = mimo_resnet_state_dict_from_jax({"params": _np(jgrads),
                                            "batch_stats": _np(mutated["batch_stats"])})
    for name, t in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), atol=1e-6, rtol=2e-6,
                                       err_msg=name)
    _assert_grads(_grads_of(model), {n: want[n] for n, _ in model.named_parameters()})


def _jax_instance_perms(key, b, m=4):
    return np.stack([np.asarray(jax.random.permutation(k, b)) for k in jax.random.split(key, m)])


def test_five_sgd_steps_with_batchnorm_match_jax_in_float64(monkeypatch):
    """setup_fashionmnist's MIMO ResNet (MIMO-shuffle-instance, SGD lr 0.1,
    momentum 0.9, wd 1e-3) in both packages from the same weights, in
    float64: five train steps with BatchNorm in training mode and the
    permutations JAX drew; losses (1e-6 relative), parameters, running
    statistics and the momentum buffers (1e-6) after each / the five steps."""
    b = 8
    rng = np.random.default_rng(11)
    batches = [(rng.uniform(0, 1, (b, 4, 1, 14, 14)).astype(np.float32),
                rng.integers(0, 10, b)) for _ in range(5)]
    jmodel = JaxResNet(num_channels=1, emb_dim=4, out_dim=4, num_classes=10)
    variables = _resnet_variables(jmodel, batches[0][0], seed=3)

    def init_state(model, optimizer, sample_x, key, *, accum=1):
        params, stats = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                                variables[k]) for k in ("params", "batch_stats"))
        return TrainState(params=params, opt_state=optimizer.init(params), batch_stats=stats,
                          step=jnp.zeros((), jnp.int32), accum_grads=None)

    monkeypatch.setattr(jax_zoo, "_init_state", init_state)
    perms = []
    with jax.enable_x64(True):
        js = jax_zoo.setup_fashionmnist(model_type="MIMO-shuffle-instance",
                                        seed_key=jax.random.key(0), attn_impl="xla")
        jstep = build_train_step(js.bundle, js.optimizer, donate=False)
        ts = setup_fashionmnist(model_type="MIMO-shuffle-instance", device="cpu")
        ts.model.load_state_dict(mimo_resnet_state_dict_from_jax(variables), strict=True)
        ts.model.double()
        opt = optim.SGD(ts.model.named_parameters(), ts.schedule, momentum=0.9, weight_decay=1e-3)
        bundle = dataclasses.replace(ts.bundle, data_forming=lambda gen, x, y, phase: (
            data_forming.data_forming_func(x, y, phase=phase, model_type="MIMO-shuffle-instance",
                                           perms=perms[-1])))
        state = js.state
        for i, (x, y) in enumerate(batches, start=1):
            key = jax.random.key(100 + i)
            perms.append(_jax_instance_perms(jax.random.split(key, 3)[0], b))
            state, jlogs = jstep(state, jnp.asarray(x), jnp.asarray(y), key)
            tlogs = train_step(bundle, opt, torch.from_numpy(x), torch.from_numpy(y))
            np.testing.assert_allclose(float(tlogs["loss"]), float(jlogs["loss"]), rtol=1e-6,
                                       err_msg=f"loss at step {i}")
            assert float(tlogs["acc"]) == pytest.approx(float(jlogs["acc"]), abs=1e-9)
        state = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), state)
    assert opt.step == int(state.opt_state["step"]) == 5
    want = mimo_resnet_state_dict_from_jax({"params": state.params,
                                            "batch_stats": state.batch_stats})
    for name, t in ts.model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(t.numpy(), want[name].numpy().astype(np.float64),
                                       atol=1e-6, rtol=0, err_msg=name)
    momentum = mimo_resnet_state_dict_from_jax({"params": state.opt_state["momentum"]})
    for name, t in opt.buf.items():
        np.testing.assert_allclose(t.numpy(), momentum[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=f"momentum {name}")


def test_sgd_state_round_trips_and_reads_lr_scale():
    p = torch.nn.Parameter(torch.ones(3))
    opt = optim.SGD([("p", p)], optim.constant_schedule(0.5), momentum=0.9, weight_decay=0.1)
    p.grad = torch.ones(3)
    opt.update()  # buf = 1 + 0.1, p = 1 - 0.5 x 1.1
    np.testing.assert_allclose(p.detach().numpy(), 1 - 0.5 * 1.1, rtol=1e-6)
    opt.lr_scale = 0.1
    p.grad = torch.zeros(3)
    opt.update()  # buf = 0.9 x 1.1 + 0.1 x 0.45, lr 0.05
    np.testing.assert_allclose(p.detach().numpy(), 0.45 - 0.05 * (0.99 + 0.045), rtol=1e-6)
    again = optim.SGD([("p", torch.nn.Parameter(torch.zeros(3)))], optim.constant_schedule(0.5))
    again.load_state_dict(opt.state_dict())
    assert again.step == 2 and again.lr_scale == pytest.approx(0.1)
    assert torch.equal(again.buf["p"], opt.buf["p"])
    with pytest.raises(ValueError, match="missing"):
        again.load_state_dict({**opt.state_dict(), "momentum": {}})


TF = dict(out_dim=4, num_classes=10, hidden_size=768, multimodal_num_hidden_layers=1,
          multimodal_num_attention_heads=3)


def _transformer_pair(seed, impl="xla"):
    jmodel = JaxTransformer(**TF, attn_impl=impl)
    x = np.random.default_rng(seed).uniform(0, 1, (4, 4, 1, 14, 14)).astype(np.float32)
    params = _np(jmodel.init({"params": jax.random.key(seed)}, jnp.asarray(x), train=False))
    model = MIMOTransformer(**TF)
    model.load_state_dict(mimo_transformer_state_dict_from_jax(params), strict=True)
    return jmodel, params, model, x


def _transformer_grads(jmodel, params, model, x, y):
    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x), train=True)
        return JaxTransformer.compute_loss(logits, jnp.asarray(y)), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params["params"])
    logits = model.train()(torch.from_numpy(x))
    model.compute_loss(logits, torch.from_numpy(y)).backward()
    return logits.detach().numpy(), np.asarray(jlogits), mimo_transformer_state_dict_from_jax(
        _np(jgrads))


def test_mimo_transformer_matches_jax():
    """768 wide, 3 heads (Dh 256), one token a view (S = 4): eval logits
    within 1e-5 and the training loss's gradients within 1e-4 x each leaf's
    max, the in_proj key bias (true gradient 0) aside; the reference-spelled
    alias names the same class."""
    jmodel, params, model, x = _transformer_pair(1)
    y = np.random.default_rng(2).integers(0, 10, (4, 4))
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 4, 10)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    logits, jlogits, want = _transformer_grads(jmodel, params, model, x, y)
    np.testing.assert_allclose(logits, jlogits, atol=1e-5, rtol=0)
    _assert_grads(_grads_of(model), want, skip_key_bias=True)
    key_bias = model.mm_encoder.resblocks[0].attn.in_proj.bias.grad[768:1536]
    assert float(key_bias.abs().max()) < 1e-5
    assert mimo_transformer.MIMOTransfomer is MIMOTransformer


def test_mimo_transformer_matches_jax_k1_in_interpret_mode_at_s4(monkeypatch):
    """The JAX module with ``attn_impl="pallas_interpret"``: its attention
    runs K1 itself (``_sdpa_packed_fwd_impl`` and ``_sdpa_packed_bwd_impl``,
    one call each on the packed (4, 4, 2304) projection) in interpret mode at
    S = 4; the port's logits and gradients match it as above."""
    calls = []
    for name in ("_sdpa_packed_fwd_impl", "_sdpa_packed_bwd_impl"):
        real = getattr(JA, name)

        def counting(*args, _real=real, _name=name, **kwargs):
            calls.append((_name, tuple(args[0].shape)))
            return _real(*args, **kwargs)

        monkeypatch.setattr(JA, name, counting)
    jmodel, params, model, x = _transformer_pair(3, impl="pallas_interpret")
    y = np.random.default_rng(4).integers(0, 10, (4, 4))
    calls.clear()
    logits, jlogits, want = _transformer_grads(jmodel, params, model, x, y)
    assert calls == [("_sdpa_packed_fwd_impl", (4, 4, 2304)),
                     ("_sdpa_packed_bwd_impl", (4, 4, 2304))], calls
    np.testing.assert_allclose(logits, jlogits, atol=1e-5, rtol=0)
    _assert_grads(_grads_of(model), want, skip_key_bias=True)


def test_five_bert_adam_steps_of_the_transformer_match_jax():
    """setup_fashionmnist's transformer (MIMO-shuffle-instance, 1 layer,
    BertAdam lr 1e-3, warmup 0.1 over 10 steps) in both packages from the
    same weights: five steps with the permutations JAX drew; losses within
    1e-5 relative, then parameters and BertAdam's moments within 1e-5 (the
    key bias within 2 x the sum of the learning rates)."""
    b = 6
    kw = dict(model_type="MIMO-shuffle-instance", transformer=True, lr=1e-3, warmup=0.1,
              total_steps=10, multimodal_num_hidden_layers=1)
    js = jax_zoo.setup_fashionmnist(**kw, seed_key=jax.random.key(7), attn_impl="xla")
    ts = setup_fashionmnist(**kw, device="cpu")
    ts.model.load_state_dict(mimo_transformer_state_dict_from_jax(_np(js.state.params)),
                             strict=True)
    assert ts.scheduler_metric == js.scheduler_metric == "val_acc"
    jstep = build_train_step(js.bundle, js.optimizer, donate=False)
    perms = []
    bundle = dataclasses.replace(ts.bundle, data_forming=lambda gen, x, y, phase: (
        data_forming.data_forming_func(x, y, phase=phase, model_type="MIMO-shuffle-instance",
                                       perms=perms[-1])))
    rng = np.random.default_rng(5)
    state = js.state
    for i in range(1, 6):
        x = rng.uniform(0, 1, (b, 4, 1, 14, 14)).astype(np.float32)
        y = rng.integers(0, 10, b)
        key = jax.random.key(i)
        perms.append(_jax_instance_perms(jax.random.split(key, 3)[0], b))
        state, jlogs = jstep(state, jnp.asarray(x), jnp.asarray(y), key)
        tlogs = train_step(bundle, ts.optimizer, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(tlogs["loss"]), float(jlogs["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {i}")
    assert ts.optimizer.step == 5
    noise_bound = 2 * sum(ts.schedule(t) for t in range(5))
    for key, own, ref in (("param", dict(ts.model.named_parameters()), state.params),
                          ("mu", ts.optimizer.mu, state.opt_state["mu"]),
                          ("nu", ts.optimizer.nu, state.opt_state["nu"])):
        ref = mimo_transformer_state_dict_from_jax(_np(ref))
        for name, t in own.items():
            got, want = t.detach().numpy(), ref[name].numpy()
            if name.endswith("attn.in_proj.bias"):
                d = got.shape[0] // 3
                if key == "param":
                    assert np.abs(got[d:2 * d] - want[d:2 * d]).max() <= noise_bound, name
                got, want = np.delete(got, np.s_[d:2 * d]), np.delete(want, np.s_[d:2 * d])
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=f"{key} {name}")
