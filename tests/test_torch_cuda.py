"""Hand-written Hopper kernels against their plain PyTorch versions, on
the card only (marked ``cuda``; skipped where there is no sm_90 card).
Imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
lacks.)

Tolerance: float32 atol 5e-5 (summation order, fast exp); bfloat16 atol
1e-2 + rtol 1.6e-2, as in ``chip_smoke.py`` (two bf16 ulps relative, so
one rounding difference passes at any magnitude: ``w`` is drawn from
randn, so rmsnorm outputs reach |y| > 4, where one ulp is 0.03).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import awq_matmul as awq_k  # noqa: E402
from repro_torch.kernels import decode_attention as dec_k  # noqa: E402
from repro_torch.kernels import paged_attention as pa_k  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_k  # noqa: E402


def _card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability()[0] != 9:
        pytest.skip("needs a Hopper (sm_90) CUDA card")


def _tol(dtype):
    return (5e-5, 0.0) if dtype == "float32" else (1e-2, 1.6e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hand_kernels_match_plain_on_card(dtype):
    """Each Hopper kernel against its plain version, at the local tier's
    smoke shapes (D=16, Hq/Hkv 4/2) and a full-width head (D=128, 32/8)."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability()[0] != 9:
        pytest.skip("needs a Hopper (sm_90) CUDA card")
    dt = getattr(torch, dtype)
    atol, rtol = (5e-5, 0.0) if dtype == "float32" else (1e-2, 1.6e-2)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*s):
        return torch.randn(s, generator=g, device="cuda").to(dt)

    x, w = rn(3, 64), rn(64)
    torch.testing.assert_close(rms_k.rmsnorm(x, w), rms_k.plain(x, w), atol=atol, rtol=rtol)
    for Hq, Hkv, D in ((4, 2, 16), (32, 8, 128)):
        q = rn(2, Hq, 1, D)
        kp, vp = rn(9, Hkv, 16, D), rn(9, Hkv, 16, D)
        bt = torch.tensor([[3, 4, 0], [5, 6, 7]], dtype=torch.int32, device="cuda")
        kl = torch.tensor([20, 41], dtype=torch.int32, device="cuda")
        torch.testing.assert_close(
            pa_k.paged_attention(q, kp, vp, block_tables=bt, kv_len=kl),
            pa_k.plain(q, kp, vp, block_tables=bt, kv_len=kl), atol=atol, rtol=rtol)
        k, v = rn(2, Hkv, 48, D), rn(2, Hkv, 48, D)
        torch.testing.assert_close(dec_k.decode_attention(q, k, v, kv_len=kl),
                                   dec_k.plain(q, k, v, kv_len=kl), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "float8_e4m3fn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_paged_attention_matches_plain_on_card(dtype, kv):
    """int8/fp8 pages dequantized in the kernel; scales of 1e6 in the
    trash page and past every live tail must not reach the output."""
    _card()
    dt, kdt = getattr(torch, dtype), getattr(torch, kv)
    atol, rtol = _tol(dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    for Hq, Hkv, D in ((4, 2, 16), (32, 8, 128)):
        q = torch.randn((2, Hq, 1, D), generator=g, device="cuda").to(dt)
        kp, ks = ref.quantize_kv(torch.randn((9, Hkv, 16, D), generator=g,
                                             device="cuda"), kdt)
        vp, vs = ref.quantize_kv(torch.randn((9, Hkv, 16, D), generator=g,
                                             device="cuda"), kdt)
        for s in (ks, vs):
            s[0] = s[8] = 1e6
        bt = torch.tensor([[3, 4, 0], [5, 6, 7]], dtype=torch.int32, device="cuda")
        kl = torch.tensor([20, 41], dtype=torch.int32, device="cuda")
        kw = dict(block_tables=bt, kv_len=kl, k_scales=ks, v_scales=vs)
        before = pa_k.launches_quant
        got = pa_k.paged_attention(q, kp, vp, **kw)
        torch.cuda.synchronize()
        assert pa_k.launches_quant == before + 1
        torch.testing.assert_close(got, pa_k.plain(q, kp, vp, **kw), atol=atol, rtol=rtol)
        with pytest.raises(TypeError):
            pa_k.paged_attention(q, kp, vp, block_tables=bt, kv_len=kl)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_awq_matmul_matches_plain_on_card(dtype, group):
    """Row counts across the register tiles (1, 5, 16, 40), a ragged N,
    and one main-path shape with its K split."""
    _card()
    dt = getattr(torch, dtype)
    # float32: chip_smoke.py's atol 5e-5 + rtol 1e-5 at every K (|y| reaches
    # about 10 here); dequantizing to bf16 would miss it by 40x
    atol, rtol = (5e-5, 1e-5) if dtype == "float32" else _tol(dtype)
    g = torch.Generator(device="cuda").manual_seed(2)
    for M, K, N in ((1, 256, 200), (5, 512, 384), (16, 256, 128), (40, 256, 300),
                    (8, 4096, 4096)):
        x = torch.randn((M, K), generator=g, device="cuda").to(dt)
        qw = ref.awq_pack(torch.randint(0, 16, (K, N), generator=g, device="cuda"))
        s = 0.01 * torch.rand((K // group, N), generator=g, device="cuda")
        z = torch.randint(0, 16, (K // group, N), generator=g, device="cuda").float()
        got = awq_k.awq_matmul(x, qw, s, z, group_size=group)
        torch.cuda.synchronize()
        want = awq_k.plain(x, qw, s, z, group_size=group)
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    with pytest.raises(ValueError):
        awq_k.awq_matmul(x[:, :K - 8], qw[:-1], s, z, group_size=group)
