"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and skips without one (marker
``cuda``). The file imports neither JAX nor ``ray_tpu``, so it also runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from ray_tpu_torch import device as tdevice
from ray_tpu_torch.ops import attention as tattn


@pytest.fixture(autouse=True)
def _full_fp32():
    """fp32 products at full precision whatever the process was left with:
    the plain versions are the reference here (see ``device.full_fp32``)."""
    with tdevice.full_fp32():
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d,causal,dtype", [
    (256, 256, 64, True, torch.bfloat16),
    (200, 333, 64, False, torch.bfloat16),
    (128, 128, 128, True, torch.bfloat16),
    (256, 256, 64, True, torch.float16),
    (200, 333, 128, False, torch.bfloat16),  # non-causal Sq != Sk at D 128
    (128, 384, 64, True, torch.bfloat16),    # causal Sq < Sk
    (129, 129, 64, True, torch.bfloat16),    # one tile plus one
    (200, 130, 128, True, torch.bfloat16),   # short query tile, causal Sq > Sk, D 128
    (40, 40, 64, True, torch.bfloat16),      # one short tile
    (256, 100, 64, False, torch.float16),    # Sk not a multiple of the key tile
])
def test_cuda_kernels_match_plain(cuda, sq, sk, d, causal, dtype):
    """Kernels against the plain versions on the same 16-bit inputs;
    2e-2 of the largest entry (bf16 keeps 8 bits)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    mk = lambda s: torch.randn((2, 3, s, d), generator=g, device=cuda,
                               dtype=dtype)
    q, k, v, do = mk(sq), mk(sk), mk(sk), mk(sq)
    scale = d ** -0.5
    tattn.reset_launch_counts()
    o, lse = tattn.flash_fwd(q, k, v, causal, scale)
    ro, rlse = tattn.mha_reference_with_lse(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = tattn.flash_bwd_dkdv(q, k, v, do, lse, delta, causal, scale)
    dq = tattn.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    rdk, rdv = tattn.flash_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                              causal, scale)
    rdq = tattn.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                       scale)
    torch.cuda.synchronize()
    for a, r in ((o, ro), (dq, rdq), (dk, rdk), (dv, rdv)):
        err = (a.float() - r.float()).abs().max() / r.float().abs().max()
        assert err < 2e-2
    assert (lse - rlse).abs().max() < 1e-4
    assert [f.launches for f in tattn.KERNEL_WRAPPERS] == [1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_dq_is_deterministic(cuda, d):
    """K3 writes each dq row from one block, without atomics: two launches
    on the same inputs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn((2, 3, 300, d), generator=g, device=cuda,
                               dtype=torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = tattn.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    first = tattn.flash_bwd_dq(q, k, v, do, lse, delta, True, scale)
    second = tattn.flash_bwd_dq(q, k, v, do, lse, delta, True, scale)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
