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
