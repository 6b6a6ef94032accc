"""The port's attention at the head dims of FLAVA fusion's other head counts,
against the JAX package's kernels, on the CPU.

At Dh 24, 48, 96 and 192 (32, 16, 8 and 4 heads of D=768) the JAX package
has no heads-last kernel layout (``_hl_block_width`` returns None) and runs
its heads-first kernel K6 (``_sdpa_pallas``: forward ``_sdpa_pallas_fwd_impl``,
backward ``_sdpa_bwd_impl``) after a relayout; at Dh 384 and 768 (2 and 1
heads) it runs K1 (``_sdpa_packed_fwd_impl``, ``_sdpa_packed_bwd_impl``). The
JAX side runs those kernels in interpret mode, and the tests count the calls
to show that it reached them and not XLA. The port runs its plain versions
on the CPU (the CUDA instances run only on the card, where
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold them against the same
plain versions). Widths are small (D = 96, 192, 384) except for the 1- and
2-head cases, which need D = 768.

Tolerances: fp32 1e-5 (the same math summed in another order); bf16 2e-2
forward and 3e-2 x max(1, max|ref|) backward (the two frameworks round P and
dS to bf16 at the same points but sum in other orders, and the outputs are
stored in bf16).

Also here: the CLIs reject, on the card, a head count whose head dim has no
instance, before they read any data.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.ops import attention as JA
from multimodal_uncertainty_tpu_torch.ops import attention as TA

B, S = 5, 40
# (head dim, width): 4 heads of 24, 2 of 48, 2 of 96, 2 of 192
K6_CASES = [(24, 96), (48, 96), (96, 192), (192, 384)]
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _mask(s: int, rng) -> np.ndarray:
    """The rows of ``tests/test_torch_attention.py::_mask``: 0 ragged (with
    holes), 1 image-ablated, 2 text-ablated, 3 fully masked, 4 ragged."""
    lengths = rng.integers(s // 2, s + 1, size=B)
    m = np.arange(s)[None, :] < lengths[:, None]
    m &= rng.random((B, s)) > 0.2
    m[:, 0] = True
    m[1, : s // 2] = False
    m[2, s // 2:] = False
    m[3] = False
    return m


@pytest.fixture
def jax_kernel_calls(monkeypatch):
    """Counts the JAX package's calls of its K6 and K1 kernel wrappers."""
    calls = {"k6_fwd": 0, "k6_bwd": 0, "k1_fwd": 0, "k1_bwd": 0}
    for key, name in (("k6_fwd", "_sdpa_pallas_fwd_impl"), ("k6_bwd", "_sdpa_bwd_impl"),
                      ("k1_fwd", "_sdpa_packed_fwd_impl"), ("k1_bwd", "_sdpa_packed_bwd_impl")):
        real = getattr(JA, name)

        def counting(*args, _real=real, _key=key, **kwargs):
            calls[_key] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(JA, name, counting)
    return calls


def _inputs(seed: int, d: int):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, S, 3 * d)).astype(np.float32)
    mask = _mask(S, rng)
    g = rng.normal(size=(B, S, d)).astype(np.float32)
    return qkv, mask, g


def _jax_run(entry: str, qkv, mask, g, n_head: int, dtype):
    """The JAX entry point's output and input cotangent, in fp32 numpy."""
    d = qkv.shape[-1] // 3
    jmask = jnp.asarray(mask)
    if entry == "packed":
        def fn(t):
            return JA.attention_qkv_packed(t, jmask, n_head=n_head, impl="pallas_interpret")
    else:
        def fn(t):
            return JA.attention_heads_last(t[..., :d], t[..., d:2 * d], t[..., 2 * d:], jmask,
                                           n_head=n_head, impl="pallas_interpret")
    out, vjp = jax.vjp(fn, jnp.asarray(qkv, JNP[dtype]))
    grad = vjp(jnp.asarray(g, JNP[dtype]))[0]
    return np.asarray(out.astype(jnp.float32)), np.asarray(grad.astype(jnp.float32))


def _port_run(entry: str, qkv, mask, g, n_head: int, dtype):
    """The port's entry point's output and input gradient, in fp32 numpy."""
    d = qkv.shape[-1] // 3
    x = torch.from_numpy(qkv).to(dtype).requires_grad_()
    tmask = torch.from_numpy(mask)
    if entry == "packed":
        out = TA.attention_qkv_packed(x, tmask, n_head=n_head)
    else:
        out = TA.attention_heads_last(x[..., :d], x[..., d:2 * d], x[..., 2 * d:], tmask,
                                      n_head=n_head)
    out.backward(torch.from_numpy(g).to(dtype))
    assert out.dtype == dtype and x.grad.dtype == dtype
    return out.detach().float().numpy(), x.grad.float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", ["packed", "heads_last"])
@pytest.mark.parametrize("dh,d", K6_CASES)
def test_k6_head_dims_match_jax_k6(dh, d, entry, dtype, jax_kernel_calls):
    """Forward and backward of both entry points at Dh 24/48/96/192 equal
    JAX K6 in interpret mode (one forward and one backward call of it, and
    none of K1), fully masked row included."""
    qkv, mask, g = _inputs(dh + d, d)
    n_head = d // dh
    ref_out, ref_grad = _jax_run(entry, qkv, mask, g, n_head, dtype)
    assert jax_kernel_calls == {"k6_fwd": 1, "k6_bwd": 1, "k1_fwd": 0, "k1_bwd": 0}
    out, grad = _port_run(entry, qkv, mask, g, n_head, dtype)
    np.testing.assert_allclose(out, ref_out, atol=FWD_TOL[dtype], rtol=0)
    bwd_tol = BWD_TOL[dtype] * (1.0 if dtype == torch.float32 else max(1.0, np.abs(ref_grad).max()))
    np.testing.assert_allclose(grad, ref_grad, atol=bwd_tol, rtol=0)
    assert np.abs(ref_grad[3]).max() > 0  # the fully masked row has a real gradient


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_head", [1, 2])
def test_one_and_two_heads_of_768_match_jax_k1(n_head, dtype, jax_kernel_calls):
    """Dh 768 and 384 (FLAVA fusion at 1 and 2 heads): the packed entry
    point's forward and backward equal JAX K1 in interpret mode (one call of
    each, none of K6)."""
    d = 768
    qkv, mask, g = _inputs(100 + n_head, d)
    ref_out, ref_grad = _jax_run("packed", qkv, mask, g, n_head, dtype)
    assert jax_kernel_calls == {"k6_fwd": 0, "k6_bwd": 0, "k1_fwd": 1, "k1_bwd": 1}
    out, grad = _port_run("packed", qkv, mask, g, n_head, dtype)
    np.testing.assert_allclose(out, ref_out, atol=FWD_TOL[dtype], rtol=0)
    bwd_tol = BWD_TOL[dtype] * (1.0 if dtype == torch.float32 else max(1.0, np.abs(ref_grad).max()))
    np.testing.assert_allclose(grad, ref_grad, atol=bwd_tol, rtol=0)


def test_kernel_head_dims_cover_every_fusion_head_count_to_32():
    """At FLAVA fusion's width every head count from 1 to 32 that divides
    768 into a head dim of 24 or more has an instance, forward and backward;
    48 heads and more do not, and only a CUDA device is refused."""
    for n_head in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32):
        TA.check_kernel_heads(768, n_head, "cuda")
        for who in ("attention_fwd_cuda", "attention_bwd_cuda"):
            assert 768 // n_head in TA.KERNEL_HEAD_DIMS[who]
    for n_head in (48, 64, 96, 5):
        with pytest.raises(ValueError, match=r"\[24, 32, 48, 64, 96, 128, 192, 256, 384, 768\]"):
            TA.check_kernel_heads(768, n_head, "cuda")
        TA.check_kernel_heads(768, n_head, "cpu")


def test_cpu_route_takes_a_head_dim_with_no_instance():
    """The plain CPU route is not bound to the instances: 48 heads of 768
    (Dh=16) run and equal JAX's XLA attention."""
    qkv, mask, _ = _inputs(7, 768)
    ref = JA.attention_qkv_packed(jnp.asarray(qkv), jnp.asarray(mask), n_head=48, impl="xla")
    out = TA.attention_qkv_packed(torch.from_numpy(qkv), torch.from_numpy(mask), n_head=48)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def _cli_argv(cli: str, tmp_path, n_head: int):
    if cli == "train":
        return ["--framework", "flava", "--save_path", str(tmp_path / "run"),
                "--multimodal_num_attention_heads", str(n_head)]
    if cli == "predict":
        return ["--checkpoint_path", str(tmp_path / "missing.pt"),
                "--multimodal_num_attention_heads", str(n_head)]
    return ["--save_path", str(tmp_path / "out"), "--phase", "dev", "--batch_size", "4",
            "--checkpoint_path", str(tmp_path / "missing.pt"),
            "--multimodal_num_attention_heads", str(n_head)]


def _cli_main(cli: str):
    from multimodal_uncertainty_tpu_torch import eval_transformer_robustness, predict, train

    return {"train": train.main, "predict": predict.main,
            "sweep": eval_transformer_robustness.main}[cli]


@pytest.mark.parametrize("n_head", [48, 96])
@pytest.mark.parametrize("cli", ["train", "predict", "sweep"])
def test_clis_reject_a_head_count_without_an_instance_before_loading(cli, n_head, tmp_path,
                                                                     monkeypatch, capsys):
    """On the card (``torch.cuda.is_available`` stubbed true), 48 or 96
    heads of 768 (Dh 16, 8) are a usage error that names the head dims on
    offer; the data, the labels and the checkpoint are never opened."""
    from multimodal_uncertainty_tpu_torch.data import flava_encoded
    from multimodal_uncertainty_tpu_torch.data.flava_encoded import PackedFlavaDataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "no_data"))

    def no_read(*args, **kwargs):
        raise AssertionError("data read before the head count was checked")

    monkeypatch.setattr(flava_encoded, "get_dataset_flava", no_read)
    monkeypatch.setattr(PackedFlavaDataset, "__init__", no_read)
    monkeypatch.setattr(torch, "load", no_read)
    with pytest.raises(SystemExit) as exc:
        _cli_main(cli)(_cli_argv(cli, tmp_path, n_head))
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"head dim {768 // n_head} has no kernel on the card" in err
    assert "[24, 32, 48, 64, 96, 128, 192, 256, 384, 768]" in err
    assert not (tmp_path / "no_data").exists()
