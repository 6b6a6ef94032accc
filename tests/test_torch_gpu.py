"""Tests of the port that need an NVIDIA GPU: the CUDA kernels build and run
only on the card. They skip without one. This file imports no JAX, so on a
machine with the card and no JAX it runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu_torch.ops import attention as A


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain fp32 reference stays fp32
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_route_runs_both_kernels_through_the_function(cuda_device):
    """On the card the packed entry point's forward and backward are the two
    kernels (one launch each) behind the autograd Function, and the packed
    gradient equals the plain backward (1e-4: sums over S in another order),
    a fully masked sample and a ragged last tile (S=197) included."""
    rng = np.random.default_rng(70)
    d = 256
    qkv = torch.from_numpy(rng.normal(size=(3, 197, 3 * d)).astype(np.float32))
    qkv = qkv.to(cuda_device).requires_grad_()
    mask = torch.from_numpy(rng.random((3, 197)) > 0.3).to(cuda_device)
    mask[0] = False
    g = torch.from_numpy(rng.normal(size=(3, 197, d)).astype(np.float32)).to(cuda_device)
    fwd, bwd = A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches
    out = A.attention_qkv_packed(qkv, mask, n_head=1)
    assert type(out.grad_fn).__name__ == "_PackedAttentionBackward"
    out.backward(g)
    assert (A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches) == (fwd + 1, bwd + 1)
    q, k, v = (qkv.detach()[..., i * d:(i + 1) * d] for i in range(3))
    ref = torch.cat(A.attention_bwd_plain(q, k, v, mask, g, n_head=1), dim=-1)
    torch.testing.assert_close(qkv.grad, ref, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_head,dh", [(12, 64), (2, 32)])
def test_heads_last_kernel_matches_plain_on_mmbt_masks(cuda_device, n_head, dh):
    """BERT's separate q, k, v through the forward kernel (one launch) at
    Dh=64 and the tiny config's Dh=32, on MMBT masks: ragged text, the image
    segment only (text-ablated and batch-padding rows), the image [CLS] and
    the text (image-ablated); 1e-4 (sums in another order)."""
    rng = np.random.default_rng(71)
    b, s = 4, 5 + 160
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n_head * dh)).astype(np.float32))
               .to(cuda_device) for _ in range(3))
    mask = np.zeros((b, s), bool)
    mask[:, :5] = True
    mask[0, 5:5 + 97] = True
    mask[1, 5:] = True
    mask[1, 1:5] = False
    mask = torch.from_numpy(mask).to(cuda_device)
    launches = A.attention_fwd_cuda.launches
    out = A.attention_heads_last(q, k, v, mask, n_head=n_head)
    assert A.attention_fwd_cuda.launches == launches + 1
    ref = A.attention_fwd_plain(q, k, v, mask, n_head=n_head)[0]
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_head,dh,rate,dtype,s", [
    (12, 64, 0.1, torch.float32, 165), (2, 32, 0.5, torch.float32, 165),
    *((12, 64, rate, torch.bfloat16, s) for rate in (0.1, 0.5) for s in (1, 63, 165, 517)),
    *((12, 64, 0.1, torch.bfloat16, s) for s in (64, 65, 320, 736)),
    *((2, 32, rate, torch.bfloat16, s) for rate in (0.1, 0.5) for s in (1, 63, 165, 517))])
def test_dropout_kernels_match_plain_on_mmbt_masks(cuda_device, n_head, dh, rate, dtype, s):
    """K5: the dropout forward and backward kernels (one launch each, behind
    the autograd Function) on MMBT masks equal their plain versions with the
    same keep mask, and the K2 kernels do not run. fp32: the forward within
    1e-4, the gradients within 1e-4 x max(1, max|ref|) (sums in another
    order). bf16 at BERT-base's Dh 64, rates 0.1
    and 0.5, S = 1, 63, 165 and 517, and rate 0.1 at S = 64, 65, 320 and 736,
    and at the tiny BERT's Dh 32, rates 0.1 and 0.5, S = 1, 63, 165 and 517
    (both on the tensor cores, ``csrc/attention_{fwd,bwd}_tc.cu`` and
    ``csrc/attention_{fwd,bwd}_tc_32.cu``, counted in the dropout wrappers'
    ``launches_tc``; sample 3 fully
    masked: P = 1/S through the mask): the forward within 2e-2 x max(1,
    max|ref|) (dropout scales the outputs by 1 / (1 - rate)), the gradients
    within 3e-2 x max(1, max|ref|) of the plain backward (Pd and dS rounded
    to bf16 on both sides)."""
    rng = np.random.default_rng(72 if dtype == torch.float32 else 72 + s)
    b = 4
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, s, n_head * dh)).astype(np.float32))
                  .to(cuda_device).to(dtype) for _ in range(4))
    mask = np.zeros((b, s), bool)
    mask[:, :5] = True
    mask[0, 5:5 + 97] = True
    mask[1, 5:] = True
    mask[1, 1:5] = False
    if dtype == torch.bfloat16:
        mask[3] = False
    mask = torch.from_numpy(mask).to(cuda_device)
    keep = A.draw_keep_mask((b, n_head, s, s), rate,
                            generator=torch.Generator(cuda_device).manual_seed(0),
                            device=cuda_device)
    before = (A.attention_fwd_dropout_cuda.launches, A.attention_bwd_dropout_cuda.launches,
              A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches,
              A.attention_bwd_dropout_cuda.launches_tc, A.attention_fwd_dropout_cuda.launches_tc)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = A.attention_heads_last_dropout_keep(*ins, mask, keep, n_head=n_head, rate=rate)
    out.backward(g)
    torch.cuda.synchronize()
    after = (A.attention_fwd_dropout_cuda.launches, A.attention_bwd_dropout_cuda.launches,
             A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches,
             A.attention_bwd_dropout_cuda.launches_tc, A.attention_fwd_dropout_cuda.launches_tc)
    on_tc = int(dtype == torch.bfloat16)
    assert tuple(a - b_ for a, b_ in zip(after, before)) == (1, 1, 0, 0, on_tc, on_tc)
    assert (A.bwd_source(dtype, dh, True) in A.TC_BWD_SOURCES) == bool(on_tc)
    assert (A.fwd_source(dtype, dh, True) in A.TC_FWD_SOURCES) == bool(on_tc)
    ref = A.attention_probs_dropout(q, k, v, mask, n_head=n_head, rate=rate, keep=keep)
    bwd_tol = 1e-4 if dtype == torch.float32 else 3e-2
    fwd_atol = 1e-4 if dtype == torch.float32 else 2e-2 * max(1.0, float(ref.float().abs().max()))
    torch.testing.assert_close(out.float(), ref.float(), atol=fwd_atol, rtol=0)
    grads = A.attention_bwd_dropout_plain(q, k, v, mask, keep, g, n_head=n_head, rate=rate)
    for t, want in zip(ins, grads):
        assert t.grad.dtype == dtype and bool(torch.isfinite(t.grad.float()).all())
        torch.testing.assert_close(
            t.grad.float(), want.float(),
            atol=bwd_tol * max(1.0, float(want.float().abs().max())), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("k,din,dout", [(5920, 768, 3072), (5920, 768, 768), (32, 768, 768),
                                        (1001, 384, 640)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_kernel_matches_plain(cuda_device, k, din, dout, dtype):
    """The dW kernel against ``dw_plain`` at ViLT's shapes and a K that is no
    multiple of any tile, 1e-4 x max(1, max|plain|): fp32 sums of K products
    in another order (bf16 inputs are widened exactly)."""
    from multimodal_uncertainty_tpu_torch.ops import dw

    g = torch.Generator(device=cuda_device).manual_seed(k)
    x = torch.randn(k, din, device=cuda_device, generator=g).to(dtype)
    dy = torch.randn(k, dout, device=cuda_device, generator=g).to(dtype)
    before = dw.dw_cuda.launches
    out = dw.weight_grad(x, dy)
    ref = dw.dw_plain(x, dy)
    assert dw.dw_cuda.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (dout, din)
    torch.testing.assert_close(out, ref, atol=1e-4 * max(1.0, float(ref.abs().max())), rtol=0)


@pytest.mark.gpu
def test_fast_dw_linear_runs_the_kernel_through_the_function(cuda_device):
    """A training-mode ``fast_dw`` Linear on the card: one dW launch per
    backward, the pooler's strided x[:, 0] read in place, and the gradients of
    autograd's plain product (1e-4 relative to their scale)."""
    from multimodal_uncertainty_tpu_torch.models.layers import Linear
    from multimodal_uncertainty_tpu_torch.ops import dw

    lin = Linear(768, 768, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    lin.fast_dw = True
    x = torch.randn(32, 185, 768, device=cuda_device)
    before = dw.dw_cuda.launches
    lin(x[:, 0]).square().sum().backward()
    assert dw.dw_cuda.launches == before + 1
    w = lin.weight.detach().clone().requires_grad_()
    torch.nn.functional.linear(x[:, 0], w, lin.bias.detach()).square().sum().backward()
    torch.testing.assert_close(lin.weight.grad, w.grad,
                               atol=1e-4 * max(1.0, float(w.grad.abs().max())), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [24, 48, 96, 192, 384, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_fusion_head_dim_runs_its_instance(cuda_device, dh, dtype):
    """FLAVA fusion's other head counts at D=768 (32, 16, 8, 4, 2 and 1 heads):
    the packed entry point's forward and backward launch the instances of
    their head dim (one each, counted by head dim) and equal the plain
    versions, a fully masked row and a ragged last tile (S=197) included.
    Forward 1e-4 / 2e-2 (fp32 / bf16: sums in another order, one bf16
    rounding of the output); backward 1e-4 / 3e-2 x max(1, max|ref|)."""
    rng = np.random.default_rng(dh)
    d, b, s = 768, 3, 197
    n_head = d // dh
    qkv = torch.from_numpy(rng.normal(size=(b, s, 3 * d)).astype(np.float32)).to(cuda_device)
    qkv = qkv.to(dtype)
    g = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)).to(cuda_device).to(dtype)
    mask = torch.from_numpy(rng.random((b, s)) > 0.3).to(cuda_device)
    mask[0] = False
    fwd = A.attention_fwd_cuda.launches_by_dh.get(dh, 0)
    bwd = A.attention_bwd_cuda.launches_by_dh.get(dh, 0)
    x = qkv.clone().requires_grad_()
    out = A.attention_qkv_packed(x, mask, n_head=n_head)
    out.backward(g)
    assert A.attention_fwd_cuda.launches_by_dh[dh] == fwd + 1
    assert A.attention_bwd_cuda.launches_by_dh[dh] == bwd + 1
    q, k, v = (qkv[..., i * d:(i + 1) * d] for i in range(3))
    ref = A.attention_fwd_plain(q, k, v, mask, n_head=n_head)[0]
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    ref_g = torch.cat(A.attention_bwd_plain(q, k, v, mask, g, n_head=n_head), dim=-1).float()
    btol = (1e-4 if dtype == torch.float32 else 3e-2) * max(1.0, float(ref_g.abs().max()))
    torch.testing.assert_close(x.grad.float(), ref_g, atol=btol, rtol=0)


@pytest.mark.gpu
def test_head_dim_without_an_instance_raises_on_the_card(cuda_device):
    """48 heads of D=768 (Dh=16) have no instance: the card raises, naming
    the head dims on offer, and launches nothing."""
    qkv = torch.zeros(2, 8, 3 * 768, device=cuda_device)
    before = A.attention_fwd_cuda.launches
    with pytest.raises(ValueError, match="head dim 16"):
        A.attention_qkv_packed(qkv, None, n_head=48)
    with pytest.raises(ValueError, match="768"):
        A.check_kernel_heads(768, 48, cuda_device)
    assert A.attention_fwd_cuda.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_flash_runs_the_kernels_at_long_s(cuda_device, dtype):
    """The long-context entry at S=4096, 12 heads of 64 (bench_flash's
    widths): one forward and one backward launch behind the autograd
    Function, equal to the plain versions with bench_flash's mask on sample
    0, every key on sample 1 and none on sample 2 (the uniform average).
    fp32: forward 1e-4, backward 1e-4 x max(1, max|ref|). bf16 rounds
    relative to the magnitude and at this S the outputs and gradients sit
    well below 1, so its gates scale with the reference itself: forward 2e-2
    x max|ref|, backward 3e-2 x max|ref|."""
    rng = np.random.default_rng(73)
    b, s, d, n_head = 3, 4096, 768, 12
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
                  .to(cuda_device).to(dtype) for _ in range(4))
    mask = torch.ones(b, s, dtype=torch.bool, device=cuda_device)
    mask[0, (4 * s) // 5:] = False
    mask[2] = False
    before = (A.attention_fwd_cuda.launches_by_dh.get(64, 0),
              A.attention_bwd_cuda.launches_by_dh.get(64, 0))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = A.attention_flash(*ins, mask, n_head=n_head)
    out.backward(g)
    assert (A.attention_fwd_cuda.launches_by_dh[64], A.attention_bwd_cuda.launches_by_dh[64]) \
        == (before[0] + 1, before[1] + 1)
    def gate(tol32, tol16, want):
        peak = float(want.float().abs().max())
        return tol32 * max(1.0, peak) if dtype == torch.float32 else tol16 * peak

    ref = A.attention_fwd_plain(q, k, v, mask, n_head=n_head)[0]
    torch.testing.assert_close(out.float(), ref.float(), atol=gate(1e-4, 2e-2, ref), rtol=0)
    for t, want in zip(ins, A.attention_bwd_plain(q, k, v, mask, g, n_head=n_head)):
        torch.testing.assert_close(t.grad.float(), want.float(), atol=gate(1e-4, 3e-2, want),
                                   rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,eps,mean", [((128 * 320, 768), 1e-5, 0.0),
                                            ((32 * 185, 768), 1e-12, 0.0),
                                            ((300, 64), 1e-5, 0.0), ((4, 7, 100), 1e-5, 0.0),
                                            ((64, 128), 1e-5, 300.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernel_matches_plain(cuda_device, shape, eps, mean, dtype):
    """K7 against the plain LayerNorm: FLAVA's and ViLT's widths, a ragged
    row count, D=100 (no 16-byte vector in bf16), and bf16 rows around 300;
    one launch each. fp32 1e-5 x max(1, max|ref|) (sums in another order);
    bf16 one rounding step of the largest output, 2^-7 x max|ref|."""
    from multimodal_uncertainty_tpu_torch.ops import norms

    rng = np.random.default_rng(shape[-1])
    x = torch.from_numpy((mean + rng.normal(size=shape)).astype(np.float32))
    x = x.to(cuda_device).to(dtype)
    w = torch.from_numpy((1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=shape[-1])).astype(np.float32))
    w, b = w.to(cuda_device), b.to(cuda_device)
    before = norms.layer_norm_cuda.launches
    with torch.no_grad():
        y = norms.layer_norm_kernel(x, w, b, eps)
    assert norms.layer_norm_cuda.launches == before + 1
    ref = norms.layer_norm(x, w, b, eps)
    assert y.dtype == dtype and y.shape == x.shape
    scale = max(1.0, float(ref.float().abs().max()))
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0 ** -7 * scale
    torch.testing.assert_close(y.float(), ref.float(), atol=tol, rtol=0)
    with pytest.raises(RuntimeError, match="forward only"):
        norms.layer_norm_kernel(x, w.requires_grad_(), b, eps)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 7, 63, 5920, 70144 + 13])
def test_bf16_dw_runs_the_tensor_core_kernel(cuda_device, k):
    """bf16 dW at fc1's widths (768 x 3072) on the kernel ``dw_route`` names:
    K of one row, of less than one 64-row stage and a ragged stage (at or
    under ``MMA_MAX_K``: the small-K ``mma.sync`` kernel), ViLT's 32 x 185 rows and
    K8b's 70144 plus a ragged tail (the stream-K tensor-core kernel). Only
    that route's count moves. Against ``dw_plain``, 1e-4 x max(1,
    max|plain|): bf16 products are exact and both sum in fp32, in another
    order."""
    from multimodal_uncertainty_tpu_torch.ops import dw

    g = torch.Generator(device=cuda_device).manual_seed(k)
    x = torch.randn(k, 768, device=cuda_device, generator=g).to(torch.bfloat16)
    dy = torch.randn(k, 3072, device=cuda_device, generator=g).to(torch.bfloat16)
    route = dw.dw_route(k, torch.bfloat16)
    assert route == ("mma" if k <= dw.MMA_MAX_K else "tc")
    counters = ("launches", "launches_tc", "launches_mma", "launches_simt", "launches_tc32")
    before = [getattr(dw.dw_cuda, c) for c in counters]
    out = dw.weight_grad(x, dy)
    assert [getattr(dw.dw_cuda, c) - n for c, n in zip(counters, before)] == [
        1, route == "tc", route == "mma", 0, 0]
    ref = dw.dw_plain(x, dy)
    assert out.dtype == torch.float32 and out.shape == (3072, 768)
    torch.testing.assert_close(out, ref, atol=1e-4 * max(1.0, float(ref.abs().max())), rtol=0)


@pytest.mark.gpu
def test_bf16_dw_reads_a_strided_view_in_place(cuda_device):
    """The pooler's x[:, 0] in bf16 (row stride S x D, a multiple of 8) goes to
    the small-K ``mma.sync`` kernel (K = 32) as it is, and past ``MMA_MAX_K``
    to the stream-K kernel; a view whose row stride breaks the 16-byte rule is refused, not
    copied."""
    from multimodal_uncertainty_tpu_torch.ops import dw

    g = torch.Generator(device=cuda_device).manual_seed(5)
    for batch, route in ((32, "mma"), (dw.MMA_MAX_K + 32, "tc")):
        x = torch.randn(batch, 185, 768, device=cuda_device, generator=g).to(torch.bfloat16)
        dy = torch.randn(batch, 768, device=cuda_device, generator=g).to(torch.bfloat16)
        assert dw.dw_route(batch, torch.bfloat16) == route
        before = getattr(dw.dw_cuda, f"launches_{route}")
        out = dw.dw_cuda(x[:, 0], dy)
        assert getattr(dw.dw_cuda, f"launches_{route}") == before + 1
        ref = dw.dw_plain(x[:, 0], dy)
        torch.testing.assert_close(out, ref, atol=1e-4 * max(1.0, float(ref.abs().max())),
                                   rtol=0)
        odd = torch.zeros(batch, 772, device=cuda_device, dtype=torch.bfloat16)[:, :768]
        with pytest.raises(ValueError, match="multiple of 8"):  # stride 772
            dw.dw_cuda(odd, dy)


def _bf16_pair(device, k, din, dout, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(k, din, device=device, generator=g).to(torch.bfloat16),
            torch.randn(k, dout, device=device, generator=g).to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 32, 96, "limit", "past"])
@pytest.mark.parametrize("din,dout", [(768, 768), (2048, 768)])
def test_bf16_small_k_dw_matches_plain(cuda_device, k, din, dout):
    """bf16 dW on the small-K ``mma.sync`` kernel (route ``mma``, forced) at
    K = 1, the pooler's 32, MMBT's image embedding's 96, ``MMA_MAX_K`` and
    one past it (two 128-row slabs), at 768 x 768 and 2048 x 768: one launch
    counted in ``launches_mma``, ``dw_plain``'s result within 1e-4 x max(1,
    max|plain|) (bf16 products exact, fp32 sums in another order)."""
    from multimodal_uncertainty_tpu_torch.ops import dw

    k = {"limit": dw.MMA_MAX_K, "past": dw.MMA_MAX_K + 1}.get(k, k)
    x, dy = _bf16_pair(cuda_device, k, din, dout, k + din)
    before = (dw.dw_cuda.launches, dw.dw_cuda.launches_mma)
    out = dw.dw_cuda(x, dy, route="mma")
    assert (dw.dw_cuda.launches, dw.dw_cuda.launches_mma) == (before[0] + 1, before[1] + 1)
    ref = dw.dw_plain(x, dy)
    assert out.dtype == torch.float32 and out.shape == (dout, din)
    torch.testing.assert_close(out, ref, atol=1e-4 * max(1.0, float(ref.abs().max())), rtol=0)


# the bf16 --fast_dw paths' shapes above the small-K threshold: FLAVA's train step (batch 32 x
# 320 rows: fc1, fc2, out_proj, in_proj; its projections' 32 x 224; the train CLI's batch 128),
# MMBT's micro-step (32 x 165), a ragged K, and K8b's 70144 + 13
STREAM_K_SHAPES = ((10240, 768, 3072), (10240, 3072, 768), (10240, 768, 768), (10240, 768, 2304),
                   (7168, 768, 768), (40960, 768, 3072), (5280, 768, 3072), (5280, 3072, 768),
                   (1001, 384, 640), (129, 768, 768), (70144 + 13, 768, 3072), (0, 768, 3072))


@pytest.mark.gpu
@pytest.mark.parametrize("k,din,dout", STREAM_K_SHAPES)
def test_bf16_stream_k_dw_matches_plain(cuda_device, k, din, dout):
    """bf16 dW on the stream-K tensor-core kernel (route ``tc``, forced) at
    each shape: one launch counted in ``launches_tc``, ``dw_plain``'s result
    within 1e-4 x max(1, max|plain|), K = 0 an exact zero."""
    from multimodal_uncertainty_tpu_torch.ops import dw

    x, dy = _bf16_pair(cuda_device, k, din, dout, k + din + dout)
    before = (dw.dw_cuda.launches, dw.dw_cuda.launches_tc)
    out = dw.dw_cuda(x, dy, route="tc")
    assert (dw.dw_cuda.launches, dw.dw_cuda.launches_tc) == (before[0] + 1, before[1] + 1)
    ref = dw.dw_plain(x, dy)
    assert out.dtype == torch.float32 and out.shape == (dout, din)
    torch.testing.assert_close(out, ref, atol=1e-4 * max(1.0, float(ref.abs().max())), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("k,din,dout", [(10240, 768, 3072), (10240, 768, 768), (1001, 384, 640)])
def test_bf16_stream_k_dw_is_the_same_bit_for_bit(cuda_device, k, din, dout):
    """Two calls of the stream-K kernel on the same inputs give the same bits:
    the partials of a tile are added in a fixed order, with no atomics."""
    from multimodal_uncertainty_tpu_torch.ops import dw

    x, dy = _bf16_pair(cuda_device, k, din, dout, 7)
    first = dw.dw_cuda(x, dy, route="tc")
    assert torch.equal(first, dw.dw_cuda(x, dy, route="tc"))


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 65, 1000, 4096])
@pytest.mark.parametrize("layout", ["packed", "heads_last"])
def test_bf16_dh64_backward_runs_the_tensor_core_kernels(cuda_device, s, layout):
    """bf16 at 12 heads of 64 through both entry points (the packed (B, S, 3D)
    projection, row stride 3D, gradient written into its slices; BERT's
    separate heads-last q, k, v): one forward and one backward launch, the
    backward on the tensor-core route, equal to the plain backward with
    bench_flash's mask on sample 0, every key on sample 1 and none on sample 2
    (the uniform average). The bf16 gates of the other checks: 3e-2 x
    max(1, max|ref|), and at S=4096, where the gradients sit well below 1,
    3e-2 x max|ref|."""
    rng = np.random.default_rng(s)
    b, d, n_head = 3, 768, 12
    mask = torch.ones(b, s, dtype=torch.bool, device=cuda_device)
    mask[0, (4 * s) // 5:] = False
    mask[2] = False
    g = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)).to(cuda_device)
    g = g.to(torch.bfloat16)
    before = (A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches,
              A.attention_bwd_cuda.launches_tc)
    if layout == "packed":
        qkv = torch.from_numpy(rng.normal(size=(b, s, 3 * d)).astype(np.float32))
        qkv = qkv.to(cuda_device).to(torch.bfloat16)
        x = qkv.clone().requires_grad_()
        A.attention_qkv_packed(x, mask, n_head=n_head).backward(g)
        got = [x.grad[..., i * d:(i + 1) * d] for i in range(3)]
        q, k, v = (qkv[..., i * d:(i + 1) * d] for i in range(3))
    else:
        q, k, v = (torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
                   .to(cuda_device).to(torch.bfloat16) for _ in range(3))
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        A.attention_heads_last(*ins, mask, n_head=n_head).backward(g)
        got = [t.grad for t in ins]
    after = (A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches,
             A.attention_bwd_cuda.launches_tc)
    assert tuple(a - b_ for a, b_ in zip(after, before)) == (1, 1, 1)
    for t, want in zip(got, A.attention_bwd_plain(q, k, v, mask, g, n_head=n_head)):
        peak = float(want.float().abs().max())
        tol = 3e-2 * (peak if s >= 4096 else max(1.0, peak))
        assert t.dtype == torch.bfloat16 and bool(torch.isfinite(t.float()).all())
        torch.testing.assert_close(t.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 63, 64, 65, 165, 4096])
@pytest.mark.parametrize("layout", ["packed", "heads_last"])
def test_bf16_dh64_forward_runs_the_tensor_core_kernel(cuda_device, s, layout):
    """bf16 at 12 heads of 64 through the packed (B, S, 3D) projection (row
    stride 3D) and BERT's separate q, k, v: one forward launch, on the
    tensor-core route, equal to the plain forward with a random key mask on
    sample 0, every key on sample 1 and none on sample 2 (the uniform
    average, lse -1e30). Phase 2's bf16 gates: out within 2e-2 + 2^-7 x
    |plain| element by element (sums in another order, one bf16 rounding of
    each side), lse within 2e-2."""
    rng = np.random.default_rng(1000 + s)
    b, d, n_head = 3, 768, 12
    mask = torch.from_numpy(rng.random((b, s)) > 0.3).to(cuda_device)
    mask[0, 0] = True
    mask[1] = True
    mask[2] = False
    if layout == "packed":
        qkv = torch.from_numpy(rng.normal(size=(b, s, 3 * d)).astype(np.float32))
        qkv = qkv.to(cuda_device).to(torch.bfloat16)
        q, k, v = (qkv[..., i * d:(i + 1) * d] for i in range(3))
    else:
        q, k, v = (torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
                   .to(cuda_device).to(torch.bfloat16) for _ in range(3))
    before = (A.attention_fwd_cuda.launches, A.attention_fwd_cuda.launches_tc)
    out, lse = A.attention_fwd_cuda(q, k, v, mask, n_head=n_head)
    assert (A.attention_fwd_cuda.launches, A.attention_fwd_cuda.launches_tc) == (
        before[0] + 1, before[1] + 1)
    ref, ref_lse = A.attention_fwd_plain(q, k, v, mask, n_head=n_head)
    assert out.dtype == torch.bfloat16 and out.shape == (b, s, d)
    assert bool(torch.isfinite(out.float()).all())
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 2e-2 + 2.0 ** -7 * ref.float().abs()).all()), float(err.max())
    torch.testing.assert_close(lse, ref_lse, atol=2e-2, rtol=0)
    assert bool((lse[2] == A.NEG_INF).all())


@pytest.fixture
def loaded_sources(monkeypatch):
    """The CUDA sources the launches ask ``_build.load`` for, in order."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    names, real = [], _build.load

    def load(name):
        names.append(name)
        return real(name)

    monkeypatch.setattr(_build, "load", load)
    return names


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [256, 384, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_forward_runs_the_cluster_kernel_at_a_ragged_s(cuda_device, loaded_sources, dh,
                                                            dtype):
    """The forward at Dh 256 / 384 / 768 (FLAVA fusion at 3 / 2 / 1 heads) at
    S=301, no multiple of the 64-row blocks or the 32-key tiles, on the
    packed projection (row stride 3D) and on separate q, k, v: one launch
    each, of the source ``fwd_source`` names (in fp32
    ``csrc/attention_fwd_256.cu``, one block a row tile, and
    ``csrc/attention_fwd_wide.cu``, clusters; in bf16 the tensor-core kernels
    ``csrc/attention_fwd_tc_{256,384,768}.cu``, on clusters at 384 and 768), equal to
    the plain forward with a random key mask, a fully masked sample (the
    uniform average, lse exactly -1e30) and a sample with every key. Phase
    2's gates: out within 1e-4 / 2e-2 + 2^-7 x |plain| element by element
    (sums in another order; in bf16 one rounding of each side), lse within
    1e-4 / 2e-2."""
    rng = np.random.default_rng(dh + 302)
    b, s, d = 3, 301, 768
    n_head = d // dh
    mask = torch.from_numpy(rng.random((b, s)) > 0.3).to(cuda_device)
    mask[1] = False
    mask[2] = True
    qkv = torch.from_numpy(rng.normal(size=(b, s, 3 * d)).astype(np.float32))
    qkv = qkv.to(cuda_device).to(dtype)
    q, k, v = (qkv[..., i * d:(i + 1) * d] for i in range(3))
    ref, ref_lse = A.attention_fwd_plain(q, k, v, mask, n_head=n_head)
    tol, rtol = (1e-4, 0.0) if dtype == torch.float32 else (2e-2, 2.0 ** -7)
    before = A.attention_fwd_cuda.launches_by_dh.get(dh, 0)
    runs = [A.attention_fwd_cuda(q, k, v, mask, n_head=n_head),
            A.attention_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), mask,
                                 n_head=n_head)]
    assert A.attention_fwd_cuda.launches_by_dh[dh] == before + 2
    assert loaded_sources == [A.fwd_source(dtype, dh, False)] * 2
    assert loaded_sources[0] == (f"attention_fwd_tc_{dh}" if dtype == torch.bfloat16
                                 else "attention_fwd_wide" if dh != 256 else "attention_fwd_256")
    for out, lse in runs:
        assert out.dtype == dtype and out.shape == (b, s, d) and lse.shape == (b, n_head, s)
        assert bool(torch.isfinite(out.float()).all())
        err = (out.float() - ref.float()).abs()
        assert bool((err <= tol + rtol * ref.float().abs()).all()), float(err.max())
        torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=0)
        assert bool((lse[1] == A.NEG_INF).all())


def _split_fp32_forward_case(device, dh, s, rate, seed):
    """fp32 q, k, v of 768 / dh heads at B=3, S=s (a random key mask, sample
    1 fully masked, sample 2 with every key) through the forward on the
    packed projection (row stride 3D) and on separate q, k, v, with dropout
    at ``rate`` (the same keep mask for the plain version): both launches on
    the split-fp32 source ``fwd_source`` names (``launches_tc32``), out
    within 1e-4 (x max(1, max|ref|) with dropout, which scales P by
    1 / (1 - rate)), lse within 1e-4 and exactly -1e30 on the fully masked
    sample."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    rng = np.random.default_rng(seed)
    b, d = 3, 768
    n_head = d // dh
    mask = torch.from_numpy(rng.random((b, s)) > 0.3).to(device)
    mask[1] = False
    mask[2] = True
    qkv = torch.from_numpy(rng.normal(size=(b, s, 3 * d)).astype(np.float32)).to(device)
    q, k, v = (qkv[..., i * d:(i + 1) * d] for i in range(3))
    names, real = [], _build.load

    def load(name):
        names.append(name)
        return real(name)

    if rate:
        keep = A.draw_keep_mask((b, n_head, s, s), rate,
                                generator=torch.Generator(device).manual_seed(dh), device=device)
        ref = A.attention_probs_dropout(q, k, v, mask, n_head=n_head, rate=rate, keep=keep)
        ref_lse = A.attention_fwd_plain(q, k, v, mask, n_head=n_head)[1]
        wrapper = A.attention_fwd_dropout_cuda

        def run(*qkv_):
            return A.attention_fwd_dropout_cuda(*qkv_, mask, keep, n_head=n_head, rate=rate)
    else:
        ref, ref_lse = A.attention_fwd_plain(q, k, v, mask, n_head=n_head)
        wrapper = A.attention_fwd_cuda

        def run(*qkv_):
            return A.attention_fwd_cuda(*qkv_, mask, n_head=n_head)
    before = (wrapper.launches, wrapper.launches_tc32)
    _build.load = load
    try:
        runs = [run(q, k, v), run(q.contiguous(), k.contiguous(), v.contiguous())]
    finally:
        _build.load = real
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_tc32) == (before[0] + 2, before[1] + 2)
    assert names == [A.fwd_source(torch.float32, dh, rate > 0)] * 2
    assert names[0].startswith("attention_fwd_tc32")
    tol = 1e-4 * (max(1.0, float(ref.abs().max())) if rate else 1.0)
    for out, lse in runs:
        assert out.dtype == torch.float32 and out.shape == (b, s, d)
        assert bool(torch.isfinite(out).all())
        torch.testing.assert_close(out, ref, atol=tol, rtol=0)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
        assert bool((lse[1] == A.NEG_INF).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dh,rate", [(dh, 0.0) for dh in (24, 32, 48, 64, 96, 128, 192)]
                         + [(32, 0.1), (32, 0.5), (64, 0.1), (64, 0.5)])
def test_split_fp32_forward_matches_plain_at_a_ragged_s(cuda_device, dh, rate):
    """The fp32 forward at every head dim 24-192 (FLAVA fusion at 32 to 4
    heads, BERT's 12 of 64 and 2 of 32) and with dropout at Dh 32 and 64
    (rate 0.1 and 0.5), at S=301: no multiple of the 64- and 128-row blocks
    or of the 32- and 64-key tiles (``_split_fp32_forward_case``'s checks)."""
    _split_fp32_forward_case(cuda_device, dh, 301, rate, dh + 303 + int(100 * rate))


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 31, 32, 33, 64, 65, 127, 129, 165])
@pytest.mark.parametrize("dh", [64, 96, 128, 192])
def test_split_fp32_forward_at_the_tile_edges(cuda_device, dh, s):
    """The fp32 forward at Dh 64 (64-key tiles), 96 (32-key tiles), 128 (q in
    shared memory, 128-row blocks) and 192 (q in shared memory, 64-row blocks)
    at S on either side of a tile's, a consumer warpgroup's and a block's
    edge, and at MMBT's S=165 (``_split_fp32_forward_case``'s checks)."""
    _split_fp32_forward_case(cuda_device, dh, s, 0.0, dh + s)


@pytest.mark.gpu
@pytest.mark.parametrize("dh,rate", [(dh, 0.0) for dh in (24, 32, 48, 64, 96, 128, 192, 256,
                                                          384, 768)]
                         + [(32, 0.1), (32, 0.5), (64, 0.1), (64, 0.5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_backward_runs_the_cluster_kernel_at_a_ragged_s(cuda_device, loaded_sources, dh,
                                                             rate, dtype):
    """The backward at every head dim of FLAVA fusion's D=768 (32 to 1 heads),
    and with dropout on the probabilities at BERT's Dh 32 and 64 (rate 0.1
    and 0.5), at S=301, no multiple of the 32- or 64-row blocks or the
    32-row tiles, on the packed projection and on separate q, k, v: one
    backward launch each, of the source ``bwd_source`` names (the micro-tile
    kernel of ``csrc/attention_bwd_wide.cuh``; bf16 without dropout at every
    head dim but 32 and 128, and at Dh=64 with it, the tensor cores'), equal
    to the plain backward (with the same keep
    mask) with a random key mask, a fully masked sample (the gradient of the
    uniform average) and a sample with every key. 1e-4 / 3e-2 x max(1,
    max|ref|) (fp32: sums over S in another order; bf16: P and dS rounded,
    the gradient stored in bf16)."""
    rng = np.random.default_rng(dh + 301 + int(100 * rate))
    b, s, d = 3, 301, 768
    n_head = d // dh
    mask = torch.from_numpy(rng.random((b, s)) > 0.3).to(cuda_device)
    mask[1] = False
    mask[2] = True
    qkv = torch.from_numpy(rng.normal(size=(b, s, 3 * d)).astype(np.float32))
    qkv = qkv.to(cuda_device).to(dtype)
    g = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)).to(cuda_device).to(dtype)
    q, k, v = (qkv[..., i * d:(i + 1) * d] for i in range(3))
    tol = (1e-4 if dtype == torch.float32 else 3e-2)
    sep = [t.contiguous().requires_grad_() for t in (q, k, v)]
    if rate:
        keep = A.draw_keep_mask((b, n_head, s, s), rate,
                                generator=torch.Generator(cuda_device).manual_seed(dh),
                                device=cuda_device)
        ref = A.attention_bwd_dropout_plain(q, k, v, mask, keep, g, n_head=n_head, rate=rate)
        counter = A.attention_bwd_dropout_cuda
        before = counter.launches_by_dh.get(dh, 0)
        out, lse = A.attention_fwd_dropout_cuda(q, k, v, mask, keep, n_head=n_head, rate=rate)
        packed = A.attention_bwd_dropout_cuda(q, k, v, mask, keep, out, lse, g, n_head=n_head,
                                              rate=rate)
        A.attention_heads_last_dropout_keep(*sep, mask, keep, n_head=n_head,
                                            rate=rate).backward(g)
    else:
        ref = A.attention_bwd_plain(q, k, v, mask, g, n_head=n_head)
        counter = A.attention_bwd_cuda
        before = counter.launches_by_dh.get(dh, 0)
        x = qkv.clone().requires_grad_()
        A.attention_qkv_packed(x, mask, n_head=n_head).backward(g)
        packed = [x.grad[..., i * d:(i + 1) * d] for i in range(3)]
        A.attention_flash_fwd(*sep, mask, n_head=n_head)[0].backward(g)
    assert counter.launches_by_dh[dh] == before + 2
    assert [n for n in loaded_sources if n.startswith("attention_bwd")] == [
        A.bwd_source(dtype, dh, rate > 0)] * 2
    for i, want in enumerate(ref):
        atol = tol * max(1.0, float(want.float().abs().max()))
        for got in (packed[i], sep[i].grad):
            assert got.dtype == dtype and bool(torch.isfinite(got.float()).all())
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("k,din,dout", [(5920, 768, 3072), (5920, 3072, 768), (5920, 768, 2304),
                                        (5920, 768, 768), (32, 768, 768), (1001, 768, 768),
                                        (10240, 768, 3072), (96, 2048, 768), (64, 768, 768),
                                        (7, 384, 640)])
def test_fp32_dw_runs_the_split_tensor_core_kernel(cuda_device, k, din, dout):
    """fp32 dW on the split-fp32 wgmma kernel at ViLT's shapes, a K = 1001 that
    is no multiple of the 32-row stage, FLAVA's K = 32 x 320 rows, MMBT's
    K = 96 at 2048 x 768, K = 64, the pooler's K = 32 and a K = 7 whose Din is
    no multiple of the 256-column tile (the last four on the small-K kernel, at
    K <= ``SIMT_MAX_K``): the count of the kernel ``dw_route`` names moves by
    one a call and no other, and the result is ``dw_plain``'s within 1e-4 x
    max(1, max|plain|)."""
    from multimodal_uncertainty_tpu_torch.ops import dw

    g = torch.Generator(device=cuda_device).manual_seed(k + din)
    x = torch.randn(k, din, device=cuda_device, generator=g)
    dy = torch.randn(k, dout, device=cuda_device, generator=g)
    route = dw.dw_route(k, torch.float32)
    assert route == ("simt" if k <= dw.SIMT_MAX_K else "tc32")
    counters = ("launches", "launches_tc32", "launches_simt", "launches_tc")
    before = [getattr(dw.dw_cuda, c) for c in counters]
    out = dw.weight_grad(x, dy)
    assert [getattr(dw.dw_cuda, c) - n for c, n in zip(counters, before)] == [
        1, route == "tc32", route == "simt", 0]
    ref = dw.dw_plain(x, dy)
    assert out.dtype == torch.float32 and out.shape == (dout, din)
    torch.testing.assert_close(out, ref, atol=1e-4 * max(1.0, float(ref.abs().max())), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 7, 32, 64, 96, 128])
@pytest.mark.parametrize("din,dout", [(768, 768), (2048, 768)])
def test_small_k_dw_matches_plain(cuda_device, k, din, dout):
    """fp32 dW on the small-K kernel (route ``simt``) at K up to the 64-row
    slab and past it (two slabs), at the pooler's 768 x 768 and MMBT's image
    embedding's 2048 x 768: one launch counted in ``launches_simt``,
    ``dw_plain``'s result within 1e-4 x max(1, max|plain|)."""
    from multimodal_uncertainty_tpu_torch.ops import dw

    g = torch.Generator(device=cuda_device).manual_seed(k + din)
    x = torch.randn(k, din, device=cuda_device, generator=g)
    dy = torch.randn(k, dout, device=cuda_device, generator=g)
    before = (dw.dw_cuda.launches, dw.dw_cuda.launches_simt)
    out = dw.dw_cuda(x, dy, route="simt")
    assert (dw.dw_cuda.launches, dw.dw_cuda.launches_simt) == (before[0] + 1, before[1] + 1)
    ref = dw.dw_plain(x, dy)
    assert out.dtype == torch.float32 and out.shape == (dout, din)
    torch.testing.assert_close(out, ref, atol=1e-4 * max(1.0, float(ref.abs().max())), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,route", [(160, "tc32"), (32, "simt")])
def test_fp32_dw_reads_a_strided_view_in_place(cuda_device, batch, route):
    """The pooler's x[:, 0] in fp32 (row stride S x D, a multiple of 4) goes to
    the split-fp32 kernel (K = 160) or the small-K one (K = 32) as it is; a view
    whose row stride breaks the 16-byte rule is refused, not copied."""
    from multimodal_uncertainty_tpu_torch.ops import dw

    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn(batch, 185, 768, device=cuda_device, generator=g)
    dy = torch.randn(batch, 768, device=cuda_device, generator=g)
    before = getattr(dw.dw_cuda, f"launches_{route}")
    out = dw.dw_cuda(x[:, 0], dy)
    assert getattr(dw.dw_cuda, f"launches_{route}") == before + 1
    ref = dw.dw_plain(x[:, 0], dy)
    torch.testing.assert_close(out, ref, atol=1e-4 * max(1.0, float(ref.abs().max())), rtol=0)
    odd = torch.zeros(batch, 770, device=cuda_device)[:, :768]  # stride 770
    with pytest.raises(ValueError, match="multiple of 4"):
        dw.dw_cuda(odd, dy)


@pytest.mark.gpu
@pytest.mark.parametrize("d,mean,strided,dtype", [
    (d, 0.0, strided, dtype) for d in (768, 100) for strided in (False, True)
    for dtype in (torch.float32, torch.bfloat16)] + [
    (768, 300.0, False, torch.bfloat16), (100, 300.0, True, torch.bfloat16)])
def test_layer_norm_instances_match_plain(cuda_device, d, mean, strided, dtype):
    """K7 on its register instance (D = 768: 6 float4 or 3 uint4 a lane) and
    on the generic one (D = 100), fp32 and bf16, dense rows and the rows of a
    strided view x[:, 1] read in place, and bf16 rows around 300 (they keep
    their variance): the wrapper's instance as ``ln_instance`` says, one launch,
    and the plain LayerNorm within 1e-5 (fp32) / 2^-7 (bf16) x max(1, max|ref|)."""
    from multimodal_uncertainty_tpu_torch.ops import norms

    rng = np.random.default_rng(d + int(mean))
    full = torch.from_numpy((mean + rng.normal(size=(1000, 3, d))).astype(np.float32))
    full = full.to(cuda_device).to(dtype)
    x = full[:, 1] if strided else full[:, 1].contiguous()
    w = torch.from_numpy((1 + 0.1 * rng.normal(size=d)).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy((0.1 * rng.normal(size=d)).astype(np.float32)).to(cuda_device)
    ldx = x.stride(0)
    want = 6 if (d, dtype) == (768, torch.float32) else 3 if d == 768 else 0
    assert norms.ln_instance(d, dtype, ldx, all(
        t.data_ptr() % 16 == 0 for t in (x, w, b))) == want
    before = norms.layer_norm_cuda.launches
    with torch.no_grad():
        y = norms.layer_norm_cuda(x, w, b)
    assert norms.layer_norm_cuda.launches == before + 1
    ref = norms.layer_norm(x, w, b)
    assert y.dtype == dtype and y.shape == x.shape and y.is_contiguous()
    scale = max(1.0, float(ref.float().abs().max()))
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0 ** -7 * scale
    torch.testing.assert_close(y.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.gpu
def test_resolve_device_keeps_bf16_reductions_in_fp32(cuda_device):
    """``resolve_device`` switches cuBLAS's bf16 reduced-precision split-K
    reduction off (JAX's bf16 dots accumulate in fp32), beside TF32."""
    from multimodal_uncertainty_tpu_torch.device import resolve_device

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    resolve_device("cuda")
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def _plain_packed(qkv, key_mask=None, *, n_head):
    """``attention_qkv_packed`` through the plain forward (autograd's backward)."""
    return A.attention_fwd_plain(*A._split(qkv, n_head), key_mask, n_head=n_head)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [3, 4, 8, 16, 32, 2, 1, 6, 12, 24])
def test_bf16_flava_step_launches_the_bf16_instances(cuda_device, heads):
    """One ``setup_flava(dtype=bf16)`` train step (2 layers, batch 8, S = 224
    + 96) at 3, 4, 8, 16, 32, 2, 1, 6, 12 and 24 heads (Dh 256, 192, 96, 48,
    24, 384, 768, 128, 64, 32): exactly 2 forward and 2 backward launches,
    all at the head dim, every forward on the head dim's tensor-core source
    (``launches_tc``; ``csrc/attention_fwd_tc{_256,_192,_k6,_48,_24,_384,
    _768,_128,,_32}.cu``), every backward on its tensor-core source
    (``csrc/attention_bwd_tc{_256,_192,_k6,_48,_24,_384,_768,_128,,_32}.cu``;
    at 384 and 768 on clusters), none on the split-fp32 route; the loss within
    2e-2 relative of the same step with the plain attention."""
    from multimodal_uncertainty_tpu_torch.models import transformer as T
    from multimodal_uncertainty_tpu_torch.training.steps import train_step
    from multimodal_uncertainty_tpu_torch.zoo import setup_flava

    g = torch.Generator(device=cuda_device).manual_seed(12)
    x = (torch.randn(8, 224, 768, device=cuda_device, generator=g),
         torch.randn(8, 96, 768, device=cuda_device, generator=g))
    y = torch.randint(0, 101, (8,), device=cuda_device, generator=g)
    dh, losses = 768 // heads, []
    for plain in (False, True):
        setup = setup_flava(model_type="MIMO-shuffle-instance", n_classes=101,
                            multimodal_num_attention_heads=heads, multimodal_num_hidden_layers=2,
                            dtype=torch.bfloat16, device=cuda_device)
        counters = (A.attention_fwd_cuda, A.attention_bwd_cuda)
        before = [(c.launches, c.launches_by_dh.get(dh, 0), c.launches_tc) for c in counters]
        tc32 = A.attention_fwd_cuda.launches_tc32
        if plain:
            real = T.attention_qkv_packed
            T.attention_qkv_packed = _plain_packed
        try:
            logs = train_step(setup.bundle, setup.optimizer, x, y, torch.Generator().manual_seed(3))
            losses.append(float(logs["loss"]))
        finally:
            if plain:
                T.attention_qkv_packed = real
        after = [(c.launches, c.launches_by_dh.get(dh, 0), c.launches_tc) for c in counters]
        want = 0 if plain else 2
        want_bwd_tc = want if dh in A.TC_BWD_DIMS else 0
        assert [tuple(a - b for a, b in zip(x1, x0)) for x1, x0 in zip(after, before)] == [
            (want, want, want), (want, want, want_bwd_tc)]
        assert A.attention_fwd_cuda.launches_tc32 == tc32
        assert all(p.grad.dtype == torch.float32 for p in setup.model.parameters())
    assert A.fwd_source(torch.bfloat16, dh, False) == A.TC_FWD_SOURCE + A._TC_SUFFIX[dh]
    assert A.bwd_source(torch.bfloat16, dh, False) == (
        A.TC_BWD_SOURCE + A._TC_SUFFIX[dh] if dh in A.TC_BWD_DIMS else "attention_bwd_wide")
    assert abs(losses[0] - losses[1]) <= 2e-2 * abs(losses[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dh", A.TC_BWD_DIMS)
@pytest.mark.parametrize("s", [1, 63, 165, 301, 736])
@pytest.mark.parametrize("layout", ["packed", "heads_last"])
def test_bf16_tensor_core_backward_matches_plain(cuda_device, dh, s, layout):
    """The bf16 tensor-core backward (``csrc/attention_bwd_tc*.cu``) at every
    head dim of ``TC_BWD_DIMS`` (24, 32, 48, 64, 96, 128, 192, 256, 384, 768;
    at 384 and 768 on clusters of 2 and 4 blocks), one launch on its source
    (``launches_tc``), on the packed (B, S, 3D) projection read in
    place and on separate q, k, v, at S = 1, 63, 165, 301 (no multiple of its
    32- and 64-row tiles) and 736, with a random key mask, sample 1 fully
    masked (lse -1e30: the uniform average's gradient) and sample 2 with
    every key: within 3e-2 x max(1, max|ref|) of the plain backward (P and dS
    rounded to bf16 on both sides, sums in another order). At Dh 24 the
    packed v and the dense dout of the last head end on the tensors' last
    bytes: the kernel must not read past them."""
    rng = np.random.default_rng(74 + s + dh)
    b, d = 3, 768
    h = d // dh
    if layout == "packed":
        qkv = torch.from_numpy(rng.normal(size=(b, s, 3 * d)).astype(np.float32)).to(
            cuda_device).bfloat16()
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    else:
        q, k, v = (torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
                   .to(cuda_device).bfloat16() for _ in range(3))
    g = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)).to(cuda_device).bfloat16()
    mask = torch.from_numpy(rng.random((b, s)) > 0.3).to(cuda_device)
    mask[1] = False
    mask[2] = True
    out, lse = A.attention_fwd_cuda(q, k, v, mask, n_head=h)
    before = (A.attention_bwd_cuda.launches, A.attention_bwd_cuda.launches_tc)
    got = A.attention_bwd_cuda(q, k, v, mask, out, lse, g, n_head=h)
    torch.cuda.synchronize()
    assert (A.attention_bwd_cuda.launches - before[0],
            A.attention_bwd_cuda.launches_tc - before[1]) == (1, 1)
    assert A.bwd_source(torch.bfloat16, dh, False) == A.TC_BWD_SOURCE + A._TC_SUFFIX[dh]
    ref = A.attention_bwd_plain(q, k, v, mask, g, n_head=h)
    for a, r in zip(got, ref):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a.float()).all())
        torch.testing.assert_close(a.float(), r.float(),
                                   atol=3e-2 * max(1.0, float(r.float().abs().max())), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", A.TC_FWD_DIMS)
@pytest.mark.parametrize("s", [1, 63, 165, 301, 736])
@pytest.mark.parametrize("layout", ["packed", "heads_last"])
def test_bf16_tensor_core_forward_matches_plain(cuda_device, dh, s, layout):
    """The bf16 tensor-core forward (``csrc/attention_fwd_tc*.cu``) at every
    head dim of ``TC_FWD_DIMS`` (24, 32, 48, 64, 96, 128, 192, 256, 384, 768:
    FLAVA fusion at 32, 24, 16, 12, 8, 6, 4, 3, 2 and 1 heads, BERT's 12 x 64,
    the tiny BERT's 2 x 32; at 384 and 768 on clusters of 2 and 4 blocks), one
    launch on its source
    (``launches_tc``), on the packed (B, S, 3D) projection read in place and
    on separate q, k, v, at S = 1, 63, 165, 301 (no multiple of the 64- and
    128-row blocks) and 736, with a random key mask, sample 1 fully masked
    (the uniform average, lse exactly -1e30) and sample 2 with every key.
    Phase 2's bf16 gates: out within 2e-2 + 2^-7 x |plain| element by element
    (sums in another order, one bf16 rounding of each side), lse within
    2e-2."""
    rng = np.random.default_rng(17 * s + dh)
    b, d = 3, 768
    n_head = d // dh
    mask = torch.from_numpy(rng.random((b, s)) > 0.3).to(cuda_device)
    mask[1] = False
    mask[2] = True
    if layout == "packed":
        qkv = torch.from_numpy(rng.normal(size=(b, s, 3 * d)).astype(np.float32))
        qkv = qkv.to(cuda_device).to(torch.bfloat16)
        q, k, v = (qkv[..., i * d:(i + 1) * d] for i in range(3))
    else:
        q, k, v = (torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
                   .to(cuda_device).to(torch.bfloat16) for _ in range(3))
    before = (A.attention_fwd_cuda.launches, A.attention_fwd_cuda.launches_tc)
    out, lse = A.attention_fwd_cuda(q, k, v, mask, n_head=n_head)
    torch.cuda.synchronize()
    assert (A.attention_fwd_cuda.launches - before[0],
            A.attention_fwd_cuda.launches_tc - before[1]) == (1, 1)
    assert A.fwd_source(torch.bfloat16, dh, False) == A.TC_FWD_SOURCE + A._TC_SUFFIX[dh]
    ref, ref_lse = A.attention_fwd_plain(q, k, v, mask, n_head=n_head)
    assert out.dtype == torch.bfloat16 and out.shape == (b, s, d)
    assert bool(torch.isfinite(out.float()).all())
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 2e-2 + 2.0 ** -7 * ref.float().abs()).all()), float(err.max())
    torch.testing.assert_close(lse, ref_lse, atol=2e-2, rtol=0)
    assert bool((lse[1] == A.NEG_INF).all())


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_mmbt_attention_takes_its_bf16_routes(cuda_device, rate):
    """BERT-base's attention in bf16 at MMBT's shape (B=4, S = 5 + 160, 12 x
    64), forward and backward through the autograd Functions: without
    dropout one launch each on the tensor-core kernels (``launches_tc``);
    with dropout 0.1 one launch each of the dropout kernels' bf16 instances,
    both on the tensor cores (``attention_fwd_dropout_cuda.launches_tc``,
    ``attention_bwd_dropout_cuda.launches_tc``). Gradients within 3e-2 x max|ref| of
    autograd through the plain forward with the same keep mask."""
    rng = np.random.default_rng(73)
    b, s, d = 4, 165, 768
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)).to(cuda_device)
                  .bfloat16() for _ in range(4))
    mask = torch.ones(b, s, dtype=torch.bool, device=cuda_device)
    mask[0, 100:] = False
    keep = A.draw_keep_mask((b, 12, s, s), rate, device=cuda_device) if rate else None
    counters = (A.attention_fwd_cuda, A.attention_bwd_cuda, A.attention_fwd_dropout_cuda,
                A.attention_bwd_dropout_cuda)
    before = [c.launches for c in counters]
    tc = (A.attention_fwd_cuda.launches_tc, A.attention_bwd_cuda.launches_tc,
          A.attention_bwd_dropout_cuda.launches_tc, A.attention_fwd_dropout_cuda.launches_tc)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if rate:
        out = A.attention_heads_last_dropout_keep(*leaves, mask, keep, n_head=12, rate=rate)
    else:
        out = A.attention_heads_last(*leaves, mask, n_head=12)
    out.backward(g)
    got = [c.launches - n for c, n in zip(counters, before)]
    assert got == ([0, 0, 1, 1] if rate else [1, 1, 0, 0])
    assert (A.attention_fwd_cuda.launches_tc - tc[0], A.attention_bwd_cuda.launches_tc - tc[1],
            A.attention_bwd_dropout_cuda.launches_tc - tc[2],
            A.attention_fwd_dropout_cuda.launches_tc - tc[3]) == (
                (0, 0, 1, 1) if rate else (1, 1, 0, 0))
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    if rate:
        ref = A.attention_probs_dropout(*refs, mask, n_head=12, rate=rate, keep=keep)
    else:
        ref = A.attention_fwd_plain(*refs, mask, n_head=12)[0]
    ref.backward(g)
    for a, r in zip(leaves, refs):
        assert a.grad.dtype == torch.bfloat16
        torch.testing.assert_close(a.grad.float(), r.grad.float(),
                                   atol=3e-2 * float(r.grad.float().abs().max()), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("din,take", [(768, "pooler"), (2048, "image embedding")])
def test_bf16_fast_dw_linear_at_mmbt_shapes(cuda_device, din, take):
    """A ``fast_dw`` Linear with an fp32 weight on bf16 activations at MMBT's
    small-K shapes: the pooler's strided x[:, 0] (K = 32, row stride 165 x
    768) and the image embedding's K = 32 x 3 rows of 2048. One launch of the
    bf16 small-K ``mma.sync`` kernel (``launches_mma``), no copy of x; dW rounded to
    bf16 and widened to fp32, within 2^-7 x max|ref| of autograd's dW
    through ``F.linear`` (both sum in fp32, then round to bf16)."""
    from multimodal_uncertainty_tpu_torch.models.layers import Linear
    from multimodal_uncertainty_tpu_torch.ops import dw

    g = torch.Generator(device=cuda_device).manual_seed(13)
    if take == "pooler":
        x = torch.randn(32, 165, din, device=cuda_device, generator=g).bfloat16()[:, 0]
    else:
        x = torch.randn(32, 3, din, device=cuda_device, generator=g).bfloat16()
    lin = Linear(din, 768, generator=torch.Generator().manual_seed(1)).to(cuda_device).train()
    lin.fast_dw = True
    seen, real = [], dw.weight_grad
    dw.weight_grad = lambda a, b: seen.append((a.data_ptr(), a.dtype)) or real(a, b)
    before = (dw.dw_cuda.launches, dw.dw_cuda.launches_mma)
    try:
        lin(x).float().square().sum().backward()
    finally:
        dw.weight_grad = real
    assert (dw.dw_cuda.launches - before[0], dw.dw_cuda.launches_mma - before[1]) == (1, 1)
    assert seen == [(x.data_ptr(), torch.bfloat16)]
    w = lin.weight.detach().clone().requires_grad_()
    torch.nn.functional.linear(x, w.bfloat16(), lin.bias.detach().bfloat16()).float().square(
    ).sum().backward()
    assert lin.weight.grad.dtype == torch.float32
    assert torch.equal(lin.weight.grad, lin.weight.grad.bfloat16().float())
    torch.testing.assert_close(lin.weight.grad, w.grad,
                               atol=2.0 ** -7 * float(w.grad.abs().max()), rtol=0)


@pytest.mark.gpu
def test_device_prefetcher_pins_copies_on_a_side_stream_and_records_streams(cuda_device,
                                                                             monkeypatch):
    """``loaders.prefetch_to_device`` on the card (every batch the trainer
    moves): each batch arrives on the card equal to the loader's arrays,
    tuple and dict batches alike; every array was staged in a pinned buffer
    and copied on the one side stream (not the consumer's); each tensor
    handed out was recorded on the consumer's stream; five batches through
    three slots reuse the image buffers."""
    from multimodal_uncertainty_tpu_torch.data import loaders

    rng = np.random.default_rng(0)
    batches = []
    for i in range(5):
        x = (rng.integers(0, 30522, (32, 64 + 32 * i)), rng.integers(0, 256, (32, 224, 224, 3),
                                                                      dtype=np.uint8))
        if i % 2:
            x = {"input_ids": x[0], "pixel_values": x[1]}
        batches.append((x, rng.integers(0, 101, 32)))
    recorded, real_record = [], torch.Tensor.record_stream
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda t, s: recorded.append((t.data_ptr(), s)) or real_record(t, s))
    staged, real_stage = [], loaders._PinnedSlot.stage

    def stage(slot, index, a):
        pinned = real_stage(slot, index, a)
        staged.append((index, pinned.data_ptr(), pinned.is_pinned(),
                       torch.cuda.current_stream(cuda_device)))
        return pinned

    monkeypatch.setattr(loaders._PinnedSlot, "stage", stage)
    n = 0
    for (x, y), (xa, ya) in zip(loaders.prefetch_to_device(batches, cuda_device), batches):
        got = [*(x.values() if isinstance(x, dict) else x), y]
        want = [*(xa.values() if isinstance(xa, dict) else xa), ya]
        for t, a in zip(got, want):
            assert t.device.type == "cuda"
            np.testing.assert_array_equal(t.cpu().numpy(), a)
        n += len(got)
    current = torch.cuda.current_stream(cuda_device)
    assert len(staged) == len(recorded) == n
    assert all(pinned for _, _, pinned, _ in staged)
    side = {stream for _, _, _, stream in staged}
    assert len(side) == 1 and current not in side
    assert all(s == current for _, s in recorded)
    images = [ptr for index, ptr, _, _ in staged if index == 1]
    assert images[3] == images[0] and len(set(images)) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [24, 32, 48, 64, 96, 128, 192, 256, 384, 768])
@pytest.mark.parametrize("b,masked", [(32, False), (256, False), (3, True)])
def test_fp32_attention_at_s4_matches_plain(cuda_device, dh, b, masked):
    """The FashionMNIST transformer's attention, one token a view (S = 4, 4
    real rows of the kernels' 32- and 64-row blocks), at every head dim of
    D = 768 in fp32: no key mask at its train batch and the sweep's 4 x 64
    rows, and at B = 3 a random mask with sample 1 fully masked (its lse
    exactly -1e30). One forward and one backward launch through the packed
    Function; the output within 1e-4 of the plain forward, dq | dk | dv
    within 1e-4 x max(1, max|ref|) of the plain backward."""
    rng = np.random.default_rng(dh + b)
    d, s, n_head = 768, 4, 768 // dh
    qkv = torch.from_numpy(rng.normal(size=(b, s, 3 * d)).astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)).to(cuda_device)
    mask = None
    if masked:
        mask = torch.from_numpy(rng.random((b, s)) > 0.3).to(cuda_device)
        mask[1] = False
        mask[2] = True
    q, k, v = (qkv[..., i * d:(i + 1) * d] for i in range(3))
    ref, ref_lse = A.attention_fwd_plain(q, k, v, mask, n_head=n_head)
    ref_g = torch.cat(A.attention_bwd_plain(q, k, v, mask, g, n_head=n_head), dim=-1)
    x = qkv.clone().requires_grad_()
    before = (A.attention_fwd_cuda.launches_by_dh.get(dh, 0),
              A.attention_bwd_cuda.launches_by_dh.get(dh, 0))
    out = A.attention_qkv_packed(x, mask, n_head=n_head)
    out.backward(g)
    lse = A.attention_fwd_cuda(q, k, v, mask, n_head=n_head)[1]
    torch.cuda.synchronize()
    assert (A.attention_fwd_cuda.launches_by_dh[dh], A.attention_bwd_cuda.launches_by_dh[dh]) == (
        before[0] + 2, before[1] + 1)
    torch.testing.assert_close(out.detach(), ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    tol = 1e-4 * max(1.0, float(ref_g.abs().max()))
    torch.testing.assert_close(x.grad, ref_g, atol=tol, rtol=0)
    if masked:
        assert bool((lse[1] == A.NEG_INF).all())


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [3, 8])
def test_fmnist_transformer_step_runs_the_kernels(cuda_device, heads):
    """One train step of the FashionMNIST MIMO transformer (768 wide, 3
    layers, MIMO-shuffle-instance, batch 32, S = 4) at 3 heads (K1, Dh 256)
    and 8 (K6, Dh 96): exactly 3 forward and 3 backward launches at the head
    dim and none at another; the loss within 1e-4 relative of the same step
    with the plain attention from the same weights, batch and permutations,
    and every gradient within 1e-4 x its leaf's max |gradient| (the in_proj
    key bias, whose true gradient is 0, aside)."""
    from multimodal_uncertainty_tpu_torch.models import transformer as T
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.zoo import setup_fashionmnist

    rng = np.random.default_rng(heads)
    x = torch.from_numpy(rng.uniform(0, 1, (32, 4, 1, 14, 14)).astype(np.float32)).to(cuda_device)
    y = torch.from_numpy(rng.integers(0, 10, 32)).to(cuda_device)

    def step(attention):
        setup = setup_fashionmnist(model_type="MIMO-shuffle-instance", transformer=True, lr=1e-4,
                                   total_steps=100, multimodal_num_attention_heads=heads,
                                   device=cuda_device)
        T.attention_qkv_packed = attention
        try:
            model, bundle = setup.model, setup.bundle
            model.train()
            xf, yf = bundle.data_forming(torch.Generator().manual_seed(5), x, y, "train")
            loss = bundle.loss_fn(model(xf), yf, eval=False)
            loss.backward()
        finally:
            T.attention_qkv_packed = A.attention_qkv_packed
        return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}

    def plain(qkv, key_mask=None, *, n_head):
        d = qkv.shape[-1] // 3
        return A.attention_fwd_plain(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], key_mask,
                                     n_head=n_head)[0]

    dh = 768 // heads
    counts = (dict(A.attention_fwd_cuda.launches_by_dh), dict(A.attention_bwd_cuda.launches_by_dh))
    loss, grads = step(A.attention_qkv_packed)
    torch.cuda.synchronize()
    for before, after in zip(counts, (A.attention_fwd_cuda.launches_by_dh,
                                      A.attention_bwd_cuda.launches_by_dh)):
        moved = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        assert {k: n for k, n in moved.items() if n} == {dh: 3}
    ref_loss, ref_grads = step(plain)
    assert loss == pytest.approx(ref_loss, rel=1e-4)
    for name, gr in grads.items():
        ref = ref_grads[name]
        if name.endswith("attn.in_proj.bias"):
            gr, ref = (torch.cat([t[:768], t[1536:]]) for t in (gr, ref))  # q's and v's columns
        tol = 1e-4 * max(float(ref.abs().max()), 1e-30)
        torch.testing.assert_close(gr, ref, atol=tol, rtol=0, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_fusion_step_launches_the_forward_twice(cuda_device, dtype):
    """A FLAVA fusion train step (3 layers of 3 heads, Dh 256, B=8, S = 224 +
    96) with ``remat=True``: the attention forward kernel launches twice a
    layer (the forward and the backward's recompute), the backward once, and
    the loss and every gradient equal those of the same step without remat
    (1e-6 relative; 1e-5 / 3e-2 x max(1, max|ref|) for the gradients in fp32 /
    bf16)."""
    from multimodal_uncertainty_tpu_torch.zoo import setup_flava

    rng = np.random.default_rng(90)
    x = (torch.from_numpy(rng.normal(size=(8, 224, 768)).astype(np.float32)).to(cuda_device),
         torch.from_numpy(rng.normal(size=(8, 96, 768)).astype(np.float32)).to(cuda_device))
    y = torch.from_numpy(rng.integers(0, 5, size=(8, 2))).to(cuda_device)
    runs = {}
    for remat in (False, True):
        setup = setup_flava(model_type="MultiHead", n_classes=5, dtype=dtype, remat=remat,
                            seed=3, device=cuda_device)
        fwd, bwd = A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches
        loss = setup.bundle.loss_fn(setup.model.train()(x), y, eval=False)
        loss.backward()
        torch.cuda.synchronize()
        runs[remat] = (float(loss), {n: p.grad.float() for n, p in setup.model.named_parameters()},
                       A.attention_fwd_cuda.launches - fwd, A.attention_bwd_cuda.launches - bwd)
    (loss0, grads0, fwd0, bwd0), (loss1, grads1, fwd1, bwd1) = runs[False], runs[True]
    assert (fwd0, bwd0, fwd1, bwd1) == (3, 3, 6, 3)
    assert abs(loss1 - loss0) <= 1e-6 * abs(loss0)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    for name, ref in grads0.items():
        bound = tol * max(1.0, float(ref.abs().max()))
        assert float((grads1[name] - ref).abs().max()) <= bound, name


@pytest.mark.gpu
def test_remat_bert_draws_the_same_k5_keep_mask_on_the_card(cuda_device):
    """A small MMBT BERT (2 layers of 12 heads of 64, B=4, S=37) with
    attention-probability dropout 0.1 on K5, rematerialised: every layer's
    recompute draws its keep mask from the CUDA generator in the state of
    its forward, so the mask is the same; K5's forward launches twice a
    layer and its backward once; the gradients equal the step's without
    remat (1e-5 x max(1, max|ref|))."""
    from multimodal_uncertainty_tpu_torch.models import bert as TB

    cfg = TB.BertConfig(hidden_size=768, num_hidden_layers=2, attention_probs_dropout_prob=0.1,
                        hidden_dropout_prob=0.0)
    rng = np.random.default_rng(91)
    x0 = torch.from_numpy(rng.normal(size=(4, 37, 768)).astype(np.float32)).to(cuda_device)
    mask = torch.ones(4, 37, dtype=torch.bool, device=cuda_device)
    mask[1, 20:] = False
    drawn, real = [], A.draw_keep_mask
    A.draw_keep_mask = lambda *a, **kw: drawn.append(real(*a, **kw)) or drawn[-1]
    runs = {}
    try:
        for remat in (False, True):
            torch.manual_seed(0)
            enc = TB.BertEncoder(cfg, remat=remat,
                                 generator=torch.Generator().manual_seed(4)).to(cuda_device)
            x = x0.clone().requires_grad_()
            fwd = A.attention_fwd_dropout_cuda.launches
            bwd = A.attention_bwd_dropout_cuda.launches
            drawn.clear()
            out = enc.train()(x, mask, torch.Generator(cuda_device).manual_seed(6))
            out.square().mean().backward()
            torch.cuda.synchronize()
            runs[remat] = ([d.clone() for d in drawn], x.grad.clone(),
                           A.attention_fwd_dropout_cuda.launches - fwd,
                           A.attention_bwd_dropout_cuda.launches - bwd)
    finally:
        A.draw_keep_mask = real
    masks0, grad0, fwd0, bwd0 = runs[False]
    masks1, grad1, fwd1, bwd1 = runs[True]
    assert (fwd0, bwd0, fwd1, bwd1) == (2, 2, 4, 2)
    assert len(masks1) == 4
    for i in range(2):
        assert torch.equal(masks1[i], masks1[3 - i]) and torch.equal(masks1[i], masks0[i])
    assert float((grad1 - grad0).abs().max()) <= 1e-5 * max(1.0, float(grad0.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 768, 303), (16, 768, 101), (17, 64, 104), (32, 768, 2304),
                                   (640, 3072, 768), (5, 12, 9)])
def test_int8_route_pads_to_the_int_mm_rules(cuda_device, m, k, n):
    """The int8 product on the card (``torch._int_mm``) at the serving
    shapes that break its rules (M <= 16 rows: a pooler at a small batch; N =
    101 x 3: FLAVA's head; K not a multiple of 8): one launch each, equal to
    the CPU's exact int32 product; and a W8A8 Linear equal to the CPU's."""
    from multimodal_uncertainty_tpu_torch.models.layers import Linear, set_quantize
    from multimodal_uncertainty_tpu_torch.ops import quant as Q

    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, size=(m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, size=(n, k)).astype(np.int8))
    before = Q.int8_mm_cuda.launches
    got = Q.int8_mm(a.to(cuda_device), w.to(cuda_device).t())
    assert Q.int8_mm_cuda.launches == before + 1 and got.dtype == torch.int32
    assert torch.equal(got.cpu(), Q.int8_mm_plain(a, w.t()))
    lin = Linear(k, n, generator=torch.Generator().manual_seed(0))
    set_quantize(lin, "int8")
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    ref = lin(x)
    torch.testing.assert_close(lin.to(cuda_device)(x.to(cuda_device)).cpu(), ref,
                               atol=1e-6 * float(ref.abs().max()), rtol=1e-6)


def _tiny_fusion_predictor(tmp_path, device, **kw):
    from multimodal_uncertainty_tpu_torch.serving import FusionPredictor
    from multimodal_uncertainty_tpu_torch.training.checkpoint import save_weights
    from multimodal_uncertainty_tpu_torch.zoo import build_flava

    model = build_flava("MIMO-shuffle-instance", 5, layers=2, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    ckpt = str(tmp_path / "model.pt")
    save_weights(model, None, ckpt)
    return FusionPredictor(model, ckpt, device=device, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("written_on", ["cuda", "cpu"])
def test_artifact_launches_the_attention_kernel_on_the_card(cuda_device, tmp_path, written_on):
    """An artifact written on the card, and one written on the CPU, served on
    the card: one forward kernel launch a layer and call (the operator's
    CUDA body), answers within 1e-5 of the live predictor's on the card."""
    from multimodal_uncertainty_tpu_torch import export as E

    pred = _tiny_fusion_predictor(tmp_path, written_on, quantize="int8")
    E.export_fusion_predictor(pred, str(tmp_path / "art"), img_len=224, txt_len=96,
                              symbolic_lengths=True)
    loaded = E.load_exported(str(tmp_path / "art"), device="cuda")
    live = _tiny_fusion_predictor(tmp_path, "cuda", quantize="int8")
    rng = np.random.default_rng(5)
    img = rng.normal(size=(3, 197, 768)).astype(np.float32)
    txt = rng.normal(size=(3, 40, 768)).astype(np.float32)
    inputs = (np.pad(img, ((0, 0), (0, 27), (0, 0))), np.pad(txt, ((0, 0), (0, 24), (0, 0))),
              np.arange(224)[None].repeat(3, 0) < 197, np.arange(64)[None].repeat(3, 0) < 40)
    from multimodal_uncertainty_tpu_torch.ops import quant as Q

    fwd, int8 = A.attention_fwd_cuda.launches, Q.int8_mm_cuda.launches
    got = loaded(*inputs)
    assert A.attention_fwd_cuda.launches == fwd + 2
    assert Q.int8_mm_cuda.launches > int8
    np.testing.assert_allclose(got, live.predict(img, txt), atol=1e-5, rtol=0)
