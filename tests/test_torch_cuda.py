"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and skips without one. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from code_intelligence_tpu_torch.ops import fused_lstm as K1

# f32 kernel vs f32 plain (full-f32 matmul): only the summation order
# differs. bf16: the carry is rounded to bf16 every step, so an order
# difference can move it one bf16 ulp (2^-8 near 1), which later steps
# carry on.
ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(T, B, H, device, dtype, seed=0):
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(H)
    arrs = (rng.normal(0, 1, (T, B, 4 * H)), rng.uniform(-s, s, (4 * H, H)),
            rng.normal(0, 0.5, (B, H)), rng.normal(0, 0.5, (B, H)))
    return [torch.from_numpy(a.astype(np.float32)).to(device, dtype)
            for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T,B,H", [(7, 5, 40), (3, 33, 130), (1, 1, 8),
                                   (2, 17, 1030)])
def test_k1_matches_plain(cuda_device, dtype, T, B, H):
    args = _inputs(T, B, H, cuda_device, dtype)
    before = K1.launches.count
    out, (h, c) = K1.fused_lstm_forward(*args)
    torch.cuda.synchronize()
    assert K1.launches.count == before + T  # one launch per step
    ref_out, (ref_h, ref_c) = K1.fused_lstm_forward_plain(*args)
    for got, want in ((out, ref_out), (h, ref_h), (c, ref_c)):
        assert got.dtype == dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= ATOL[dtype], err


@pytest.mark.cuda
def test_k1_zero_steps_and_non_contiguous(cuda_device):
    x, w, h, c = _inputs(0, 2, 8, cuda_device, torch.float32)
    out, (hT, cT) = K1.fused_lstm_forward(x, w, h, c)
    assert out.shape == (0, 2, 8)
    assert torch.equal(hT, h) and torch.equal(cT, c)
    x, w, h, c = _inputs(3, 4, 8, cuda_device, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        K1.fused_lstm_forward(x, w, h.t().contiguous().t(), c)
