"""Tests of the port that need an NVIDIA card: the CUDA kernels have no CPU
mode, so these skip without one.  This file imports neither jax nor the JAX
package, so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which configures jax.)"""
import pytest
import torch

from mamba_tts_torch.config import MambaConfig
from mamba_tts_torch.models.attention import CrossAttention
from mamba_tts_torch.models.mamba import MambaBlock
from mamba_tts_torch.ops import int8_matvec as tq

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("B", [1, 4, 16])
def test_int8_matvec_kernel_matches_plain_on_card(card, B):
    g = torch.Generator(device=card).manual_seed(B)
    x = torch.randn((B, 512), generator=g, device=card).bfloat16()
    w_q, s = tq.quantize_weight(torch.randn((512, 2048), generator=g, device=card) * 0.05)
    before = tq.int8_matvec.launches
    got = tq.int8_matvec(x, w_q, s)
    torch.cuda.synchronize()
    assert tq.int8_matvec.launches == before + 1
    want = tq.int8_matvec_ref(x, w_q, s)
    # one bf16 ulp relative plus 1e-2 absolute, for summation order
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=1e-2)


def test_unported_full_sequence_paths_raise_on_card(card):
    block = MambaBlock(MambaConfig(d_model=16, d_state=4), dtype=torch.float32).to(card)
    with pytest.raises(NotImplementedError, match="pallas_scan"):
        block(torch.zeros((1, 5, 16), device=card))
    attn = CrossAttention(16, 4, dtype=torch.float32).to(card)
    K = V = torch.zeros((1, 4, 7, 4), device=card)
    with pytest.raises(NotImplementedError, match="flash"):
        attn.attend(torch.zeros((1, 128, 16), device=card), K, V)
