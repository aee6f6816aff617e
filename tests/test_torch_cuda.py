"""Hand-written Hopper kernels against their plain PyTorch versions, on
the card only (marked ``cuda``; skipped where there is no sm_90 card).
Imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
lacks.)

Tolerance: float32 atol 5e-5 (summation order, fast exp); bfloat16 atol
1e-2 + rtol 1.6e-2, as in ``chip_smoke.py`` (two bf16 ulps relative, so
one rounding difference passes at any magnitude: ``w`` is drawn from
randn, so rmsnorm outputs reach |y| > 4, where one ulp is 0.03). The SSD
scan's float32 outputs (y in float32, and the float32 state in both
types) are held to max abs error <= 1e-5 * max(1, max |plain|), the CPU
tests' bound: its sums run over up to 256 steps in another order than
the plain version's, so an element near zero may carry the rounding of
much larger terms.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import awq_matmul as awq_k  # noqa: E402
from repro_torch.kernels import decode_attention as dec_k  # noqa: E402
from repro_torch.kernels import flash_attention as fa_k  # noqa: E402
from repro_torch.kernels import paged_attention as pa_k  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_k  # noqa: E402
from repro_torch.kernels import ssm_scan as ssd_k  # noqa: E402


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


# awq_matmul at (M, K, N): row counts across the 8- and 16-row tiles and
# the prefill loop over tiles (1, 5, 8, 16, 17, 40, 250), N ragged against
# the 64/128-column tiles and, at 203, not a multiple of 4 (the 4-byte
# copies), and a main-path shape with its K split over a cluster
AWQ_SHAPES = [(1, 256, 200), (5, 512, 384), (8, 1024, 203), (16, 256, 128),
              (17, 512, 300), (40, 256, 300), (250, 512, 264), (8, 4096, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_awq_matmul_matches_plain_on_card(dtype, group):
    """Both bodies (bf16 on tensor cores, float32 on CUDA cores) at every
    row tile, ragged columns and a K split across a cluster."""
    _card()
    dt = getattr(torch, dtype)
    # float32: chip_smoke.py's atol 5e-5 + rtol 1e-5 at every K (|y| reaches
    # about 10 here); dequantizing to bf16 would miss it by 40x
    atol, rtol = (5e-5, 1e-5) if dtype == "float32" else _tol(dtype)
    g = torch.Generator(device="cuda").manual_seed(2)
    for M, K, N in AWQ_SHAPES:
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_awq_matmul_is_one_deterministic_launch_without_workspace_on_card(dtype):
    """At w2's decode shape (K split 8 ways over a cluster): one launch a
    call, two calls bit-equal, and nothing allocated but the output."""
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(8)
    M, K, N = 8, 16384, 4096
    assert awq_k.splits(M, K, N, 64, awq_k._sm_count(0)).n_split > 1
    x = torch.randn((M, K), generator=g, device="cuda").to(dt)
    qw = ref.awq_pack(torch.randint(0, 16, (K, N), generator=g, device="cuda"))
    s = 0.002 * torch.rand((K // 64, N), generator=g, device="cuda")
    z = torch.randint(0, 16, (K // 64, N), generator=g, device="cuda").float()
    first = awq_k.awq_matmul(x, qw, s, z, group_size=64)
    torch.cuda.synchronize()
    before, held = awq_k.launches, torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    second = awq_k.awq_matmul(x, qw, s, z, group_size=64)
    torch.cuda.synchronize()
    out_bytes = -(-second.numel() * second.element_size() // 512) * 512
    assert awq_k.launches == before + 1
    assert torch.cuda.max_memory_allocated() - held == out_bytes
    assert torch.equal(first, second)


def _ssd_close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-5 * max(1.0, want.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,T,H,P,N,chunk,live", [
    (2, 48, 4, 16, 16, 16, 37),          # smoke: three chunks, a padded tail
    (2, 48, 4, 16, 16, 16, 32),          # smoke: a whole chunk of padding
    (1, 256, 112, 64, 64, 256, 32),      # zamba2-7b: a 32-token piece in one chunk
    (1, 512, 112, 64, 64, 256, 256),     # zamba2-7b: a whole chunk of padding
    (1, 512, 112, 64, 64, 256, 512),     # two full chunks: the state carried
])
def test_ssd_matches_plain_on_card(dtype, b, T, H, P, N, chunk, live):
    """The Hopper SSD kernel against its plain version, from zero state
    and from h0; padded steps (dt = 0) must leave the state unchanged."""
    _card()
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((b, T, H, P), generator=g, device="cuda").to(dt_)
    dt = 1e-3 + 0.1 * torch.rand((b, T, H), generator=g, device="cuda")
    dt[:, live:] = 0.0
    A = -(1.0 + 15.0 * torch.rand(H, generator=g, device="cuda"))
    B = torch.randn((b, T, N), generator=g, device="cuda").to(dt_)
    C = torch.randn((b, T, N), generator=g, device="cuda").to(dt_)
    D = torch.randn(H, generator=g, device="cuda")
    h0 = torch.randn((b, H, P, N), generator=g, device="cuda")
    for h in (None, h0):
        before = ssd_k.launches
        y, hf = ssd_k.ssd(x, dt, A, B, C, D, chunk=chunk, h0=h)
        torch.cuda.synchronize()
        # bf16: the C.B pass, then the sub-chunk scan
        assert ssd_k.launches == before + (2 if dtype == "bfloat16" else 1)
        yp, hp = ssd_k.plain(x, dt, A, B, C, D, chunk=chunk, h0=h)
        assert y.dtype == dt_ and hf.dtype == torch.float32
        if dtype == "float32":
            _ssd_close(y, yp)
        else:
            torch.testing.assert_close(y, yp, atol=1e-2, rtol=1.6e-2)
        _ssd_close(hf, hp)
    if live < T:
        # what the padded steps hold leaves the state and the live y alone
        x2, B2, C2 = x.clone(), B.clone(), C.clone()
        for a in (x2, B2, C2):
            a[:, live:] = torch.randn(a[:, live:].shape, generator=g, device="cuda").to(dt_)
        y2, h2 = ssd_k.ssd(x2, dt, A, B2, C2, D, chunk=chunk, h0=h0)
        _ssd_close(h2, hf)
        _ssd_close(y2[:, :live].float(), y[:, :live].float())
    if live < T and live % chunk == 0:
        # padding leaves the state where the unpadded steps left it
        _, h_live = ssd_k.ssd(x[:, :live].contiguous(), dt[:, :live].contiguous(), A,
                              B[:, :live].contiguous(), C[:, :live].contiguous(), D,
                              chunk=chunk, h0=h0)
        _ssd_close(hf, h_live)
    with pytest.raises(TypeError):
        ssd_k.ssd(x, dt.to(dt_ if dtype == "bfloat16" else torch.float16), A, B, C, D,
                  chunk=chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("b,T,H,P,N,chunk,dead", [
    (2, 48, 4, 16, 16, 16, ()),              # smoke: one 16-step sub-chunk a chunk
    (1, 256, 112, 64, 64, 256, ()),          # zamba2-7b's piece, every step live
    (1, 256, 112, 64, 64, 256, (1,)),        # a dead sub-chunk between live ones
    (1, 512, 8, 64, 64, 128, (0, 3)),        # clusters of 2, a dead first sub-chunk
    (1, 96, 4, 64, 64, 48, ()),              # 16-step sub-chunks, clusters of 3
    (2, 128, 4, 16, 16, 64, (1,)),           # smoke heads, one 64-step sub-chunk a chunk
])
def test_ssd_bf16_subchunk_body_matches_ref_on_card(b, T, H, P, N, chunk, dead):
    """The bf16 body (tensor cores, sub-chunks in a thread block
    cluster, the state carried in rank order) against ``ref.ssd`` from
    h0, with whole sub-chunks of dt = 0 (skipped by the kernel): y under
    the bf16 tolerance, the float32 state to 1e-5 of its largest value;
    two calls give the same bits."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((b, T, H, P), generator=g, device="cuda").bfloat16()
    dt = 1e-3 + 0.1 * torch.rand((b, T, H), generator=g, device="cuda")
    q = ssd_k.sub_chunk(chunk)
    for j in dead:
        dt[:, j * q:(j + 1) * q] = 0.0
    A = -(1.0 + 15.0 * torch.rand(H, generator=g, device="cuda"))
    B = torch.randn((b, T, N), generator=g, device="cuda").bfloat16()
    C = torch.randn((b, T, N), generator=g, device="cuda").bfloat16()
    D = torch.randn(H, generator=g, device="cuda")
    h0 = torch.randn((b, H, P, N), generator=g, device="cuda")
    y, hf = ssd_k.ssd(x, dt, A, B, C, D, chunk=chunk, h0=h0)
    y2, h2 = ssd_k.ssd(x, dt, A, B, C, D, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(hf, h2)
    yp, hp = ref.ssd(x, dt, A, B, C, D, chunk=chunk, h0=h0)
    torch.testing.assert_close(y, yp, atol=1e-2, rtol=1.6e-2)
    _ssd_close(hf, hp)


@pytest.mark.cuda
@pytest.mark.parametrize("P,N,chunk", [(32, 32, 16), (64, 64, 1024)])
def test_ssd_refuses_a_shape_it_does_not_take_on_card(P, N, chunk):
    """A (P, N) the kernel is not built for, or a chunk past a block's
    shared memory, raises from the launch and counts no launch."""
    _card()
    b, T, H = 1, chunk, 2
    x = torch.randn((b, T, H, P), device="cuda")
    dt = torch.full((b, T, H), 0.01, device="cuda")
    A, D = -torch.ones(H, device="cuda"), torch.ones(H, device="cuda")
    B = C = torch.randn((b, T, N), device="cuda")
    before = ssd_k.launches
    with pytest.raises(RuntimeError, match="built for"):
        ssd_k.ssd(x, dt, A, B, C, D, chunk=chunk)
    assert ssd_k.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_width_attention_and_rmsnorm_on_card(dtype):
    """zamba2-7b's shapes: the shared block's decode attention (32 heads
    of D = 112, one query head per kv head, ragged kv_len) and rmsnorm at
    width 3584."""
    _card()
    dt = getattr(torch, dtype)
    atol, rtol = _tol(dtype)
    g = torch.Generator(device="cuda").manual_seed(4)

    def rn(*s):
        return torch.randn(s, generator=g, device="cuda").to(dt)

    q, k, v = rn(8, 32, 1, 112), rn(8, 32, 256, 112), rn(8, 32, 256, 112)
    kl = torch.tensor([1, 5, 16, 17, 100, 128, 255, 256], dtype=torch.int32,
                      device="cuda")
    torch.testing.assert_close(dec_k.decode_attention(q, k, v, kv_len=kl),
                               dec_k.plain(q, k, v, kv_len=kl), atol=atol, rtol=rtol)
    x, w = rn(8, 1, 3584), 1 + 0.1 * rn(3584)
    torch.testing.assert_close(rms_k.rmsnorm(x, w), rms_k.plain(x, w), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("wtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bodies_match_plain_on_card(dtype, wtype):
    """The vector body (a warp a row for narrow D, a block a row for wide
    D), the scalar body (D = 100 in bf16 is not a whole number of 16-byte
    vectors) and a contiguous but misaligned x, at a decode step's rows,
    training's 2048 and one, with and without the Gemma (1 + w)."""
    _card()
    dt, wt = getattr(torch, dtype), getattr(torch, wtype)
    atol, rtol = _tol(dtype)
    g = torch.Generator(device="cuda").manual_seed(9)
    for rows in (1, 8, 2048):
        for D in (64, 100, 3584, 4096):
            x = torch.randn((rows, D), generator=g, device="cuda").to(dt)
            for gemma in (False, True):
                w = (0.1 if gemma else 1.0) * torch.randn(D, generator=g, device="cuda")
                w = w.to(wt)
                before = rms_k.launches
                got = rms_k.rmsnorm(x, w, gemma_style=gemma)
                torch.cuda.synchronize()
                assert rms_k.launches == before + 1 and got.dtype == dt
                torch.testing.assert_close(got, rms_k.plain(x, w, gemma_style=gemma),
                                           atol=atol, rtol=rtol)
    flat = torch.randn(8 * 4096 + 1, generator=g, device="cuda").to(dt)
    x = flat[1:].view(8, 4096)                 # contiguous, 2 or 4 bytes off 16
    assert x.is_contiguous() and x.data_ptr() % 16
    w = torch.randn(4096, generator=g, device="cuda").to(wt)
    torch.testing.assert_close(rms_k.rmsnorm(x, w), rms_k.plain(x, w), atol=atol, rtol=rtol)


# flash_attention at chip_smoke.py's shapes: (B, Hq, Hkv, Sq, Skv, D, causal, cap)
FLASH_SHAPES = [
    (2, 32, 8, 1023, 1023, 128, True, 0.0),      # training: T = seq - 1
    (1, 32, 8, 250, 250, 128, True, 0.0),        # whole-prompt prefill
    (1, 32, 8, 100, 250, 128, True, 0.0),        # Skv > Sq: the offset diagonal
    (2, 32, 8, 130, 200, 128, False, 0.0),       # non-causal
    (1, 32, 8, 300, 300, 128, True, 30.0),       # soft cap
    (1, 32, 32, 250, 250, 112, True, 0.0),       # zamba2's shared block
    (2, 4, 2, 63, 63, 16, True, 0.0),            # the smoke config's training shape
    (1, 32, 8, 300, 200, 128, True, 0.0),        # causal Skv < Sq
    (2, 16, 16, 1023, 1023, 256, True, 0.0),     # gemma-7b training: D 256
    (1, 16, 16, 250, 250, 256, True, 0.0),       # gemma-7b whole-prompt prefill
    (1, 4, 2, 100, 250, 256, True, 30.0),        # D 256: offset diagonal, cap, G 2
    (1, 4, 2, 200, 130, 256, True, 0.0),         # D 256: causal Skv < Sq
    (2, 8, 2, 63, 63, 8, True, 0.0),             # deepseek-67b's smoke: D 8
    (1, 8, 2, 70, 130, 8, False, 0.0),           # D 8, non-causal
]


# granite-20b's whole-prompt prefill, G 48: the forward only (no path
# trains granite; its float32 dK sums 48 heads' terms)
FLASH_FWD_SHAPES = FLASH_SHAPES + [(1, 48, 1, 250, 250, 128, True, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,cap", FLASH_FWD_SHAPES)
def test_flash_attention_matches_plain_on_card(dtype, B, Hq, Hkv, Sq, Skv, D, causal, cap):
    _card()
    dt = getattr(torch, dtype)
    atol, rtol = _tol(dtype)
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((B, Hq, Sq, D), generator=g, device="cuda").to(dt)
    k = torch.randn((B, Hkv, Skv, D), generator=g, device="cuda").to(dt)
    v = torch.randn((B, Hkv, Skv, D), generator=g, device="cuda").to(dt)
    before = fa_k.launches
    got = fa_k.flash_attention(q, k, v, causal=causal, logit_soft_cap=cap)
    torch.cuda.synchronize()
    assert fa_k.launches == before + 1 and got.dtype == dt
    torch.testing.assert_close(got, fa_k.plain(q, k, v, causal=causal, logit_soft_cap=cap),
                               atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_gradients_match_plain_autograd_on_card(dtype):
    """flash_attention's and rmsnorm's autograd.Function: the forward is
    the kernel, the gradient that of the plain version."""
    _card()
    dt = getattr(torch, dtype)
    atol, rtol = _tol(dtype)
    g = torch.Generator(device="cuda").manual_seed(6)

    def rn(*s):
        return torch.randn(s, generator=g, device="cuda").to(dt).requires_grad_()

    for (B, Hq, Hkv, S, D) in ((2, 4, 2, 63, 16), (1, 32, 8, 130, 128)):
        q, k, v = rn(B, Hq, S, D), rn(B, Hkv, S, D), rn(B, Hkv, S, D)
        go = torch.randn((B, Hq, S, D), generator=g, device="cuda").to(dt)
        before = fa_k.launches
        out = fa_k.flash_attention(q, k, v)
        assert fa_k.launches == before + 1 and out.grad_fn is not None
        got = torch.autograd.grad(out, (q, k, v), go)
        want = torch.autograd.grad(fa_k.plain(q, k, v), (q, k, v), go)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=atol, rtol=rtol)
        # one input needing grad: the others get none
        gk, = torch.autograd.grad(fa_k.flash_attention(q.detach(), k, v.detach()), (k,), go)
        torch.testing.assert_close(gk, want[1], atol=atol, rtol=rtol)
    x, w = rn(3, 4096), rn(4096)
    gy = torch.randn((3, 4096), generator=g, device="cuda").to(dt)
    before = rms_k.launches
    y = rms_k.rmsnorm(x, w)
    assert rms_k.launches == before + 1 and y.grad_fn is not None
    got = torch.autograd.grad(y, (x, w), gy)
    want = torch.autograd.grad(rms_k.plain(x, w), (x, w), gy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_kernels_without_a_gradient_refuse_inputs_that_require_grad_on_card():
    _card()
    g = torch.Generator(device="cuda").manual_seed(7)

    def rn(*s, grad=False):
        return torch.randn(s, generator=g, device="cuda").requires_grad_(grad)

    q = rn(2, 4, 1, 16, grad=True)
    kv = rn(2, 2, 32, 16)
    kl = torch.tensor([5, 32], dtype=torch.int32, device="cuda")
    pages = rn(5, 2, 16, 16)
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device="cuda")
    qw = ref.awq_pack(torch.randint(0, 16, (64, 32), generator=g, device="cuda"))
    sc, zr = torch.rand((1, 32), device="cuda"), torch.zeros((1, 32), device="cuda")
    x = torch.randn((2, 16, 2, 16), device="cuda")
    dt = torch.full((2, 16, 2), 0.01, device="cuda")
    B = torch.randn((2, 16, 16), device="cuda")
    calls = {
        "decode_attention": lambda: dec_k.decode_attention(q, kv, kv, kv_len=kl),
        "paged_attention": lambda: pa_k.paged_attention(q, pages, pages,
                                                        block_tables=bt, kv_len=kl),
        "awq_matmul": lambda: awq_k.awq_matmul(rn(4, 64, grad=True), qw, sc, zr,
                                               group_size=64),
        "ssd": lambda: ssd_k.ssd(x.requires_grad_(), dt, -torch.ones(2, device="cuda"),
                                 B, B, torch.ones(2, device="cuda"), chunk=16),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} kernel has no gradient"):
            call()
        with torch.no_grad():
            call()                            # the same call, outside autograd, runs
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_refuses_what_it_does_not_take_on_card(dtype):
    """A head dim the kernel is not built for raises from the launch and
    counts no launch; a causal call with fewer keys than queries matches
    the plain version (rows that see no key: the mean of V)."""
    _card()
    dt = getattr(torch, dtype)
    atol, rtol = _tol(dtype)
    q = torch.randn((1, 4, 8, 32), device="cuda").to(dt)
    kv = torch.randn((1, 2, 8, 32), device="cuda").to(dt)
    before = fa_k.launches
    with pytest.raises(RuntimeError, match="built for"):
        fa_k.flash_attention(q, kv, kv)
    assert fa_k.launches == before
    g = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((1, 4, 8, 16), generator=g, device="cuda").to(dt)
    k, v = (torch.randn((1, 2, 4, 16), generator=g, device="cuda").to(dt) for _ in "kv")
    got = fa_k.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_k.launches == before + 1
    torch.testing.assert_close(got, fa_k.plain(q, k, v), atol=atol, rtol=rtol)
    torch.testing.assert_close(got[:, :, :4].float(),
                               v.float().mean(2, keepdim=True).repeat_interleave(
                                   2, 1).expand(1, 4, 4, 16), atol=atol, rtol=rtol)


# decode_attention at (B, Hq, Hkv, S, D, kv_len, cap)
DECODE_CASES = [
    (1, 32, 8, 256, 128, [256], 0.0),                              # minitron-8b, B=1
    (8, 32, 32, 256, 112, [1, 5, 16, 17, 100, 128, 255, 256], 0.0),  # zamba2's shared block
    (2, 4, 2, 48, 16, [20, 41], 0.0),                              # smoke minitron: G 2
    (2, 4, 4, 48, 16, [1, 48], 0.0),                               # smoke zamba2: G 1
    (37, 4, 2, 37, 16, list(range(1, 38)), 0.0),                   # every length 1..S
    (37, 32, 8, 37, 128, list(range(1, 38)), 0.0),
    (8, 32, 8, 256, 128, [1, 17, 40, 64, 100, 150, 200, 256], 30.0),  # soft cap
    (8, 32, 32, 256, 112, [3, 9, 60, 61, 129, 200, 254, 256], 20.0),
    (1, 48, 1, 256, 128, [256], 0.0),                              # granite-20b, B=1: G 48
    (8, 48, 1, 256, 128, [1, 17, 40, 64, 100, 150, 200, 256], 0.0),  # six head groups
    (1, 16, 16, 256, 256, [256], 0.0),                             # gemma-7b, B=1: D 256
    (8, 16, 16, 256, 256, [3, 9, 60, 61, 129, 200, 254, 256], 30.0),
    (2, 16, 2, 64, 256, [1, 64], 0.0),                             # D 256 at G 8
    (2, 8, 2, 48, 8, [20, 41], 0.0),                               # deepseek-67b's smoke: D 8
    (3, 12, 4, 48, 16, [5, 30, 48], 0.0),                          # G 3: three blocks of 1
    (8, 16, 16, 256, 192, [1, 5, 16, 17, 100, 128, 255, 256], 0.0),  # MLA's D 192
    (8, 16, 16, 256, 192, [3, 9, 60, 61, 129, 200, 254, 256], 30.0),
    (2, 4, 4, 48, 24, [20, 41], 0.0),                              # the smoke MLA's D 24
    (8, 16, 16, 256, 64, [1, 5, 16, 17, 100, 128, 255, 256], 0.0),   # whisper-medium's D 64
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,lens,cap", DECODE_CASES)
def test_decode_attention_split_matches_plain_on_card(dtype, B, Hq, Hkv, S, D, lens, cap):
    """The split kernel and its merge against the plain version: one call,
    one count, whatever the number of splits."""
    _card()
    dt = getattr(torch, dtype)
    atol, rtol = _tol(dtype)
    g = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn((B, Hq, 1, D), generator=g, device="cuda").to(dt)
    k = torch.randn((B, Hkv, S, D), generator=g, device="cuda").to(dt)
    v = torch.randn((B, Hkv, S, D), generator=g, device="cuda").to(dt)
    kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = dec_k.launches
    got = dec_k.decode_attention(q, k, v, kv_len=kl, logit_soft_cap=cap)
    torch.cuda.synchronize()
    assert dec_k.launches == before + 1 and got.dtype == dt
    torch.testing.assert_close(got, dec_k.plain(q, k, v, kv_len=kl, logit_soft_cap=cap),
                               atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 16, 24, 64, 112, 128, 192, 256])
@pytest.mark.parametrize("Sq,Skv,causal,cap", [
    (200, 200, True, 0.0), (65, 300, True, 0.0), (130, 70, True, 0.0),
    (100, 190, False, 0.0), (129, 129, True, 25.0), (1, 64, True, 0.0)])
def test_flash_attention_bf16_wgmma_body_matches_plain_on_card(D, Sq, Skv, causal, cap):
    """The bf16 body (wgmma) at each head dim it is built for: ragged
    tiles of both axes, the offset diagonal both ways, non-causal, cap."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(10)
    Hq, Hkv = {112: (32, 32), 256: (16, 16), 8: (8, 2), 192: (16, 16),
               24: (4, 4)}.get(D, (32, 8))
    q = torch.randn((2, Hq, Sq, D), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((2, Hkv, Skv, D), generator=g, device="cuda").bfloat16()
            for _ in "kv")
    got = fa_k.flash_attention(q, k, v, causal=causal, logit_soft_cap=cap)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fa_k.plain(q, k, v, causal=causal, logit_soft_cap=cap),
                               atol=1e-2, rtol=1.6e-2)


def _grads(q, k, v, go, fn, **kw):
    """(dq, dk, dv) of fn(q, k, v, **kw) against go, for fresh leaves."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(fn(*leaves, **kw), leaves, go)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,cap", FLASH_SHAPES)
def test_flash_attention_backward_kernel_matches_plain_on_card(dtype, B, Hq, Hkv, Sq, Skv, D,
                                                              causal, cap, monkeypatch):
    """The backward kernel (one launch a backward call, never the plain
    recompute) against plain autograd and against ``plain_bwd`` on the
    forward kernel's own out (plus its rounding remainder, for bf16) and
    lse; two backward calls give the same bits."""
    _card()
    from repro_torch.kernels import _build

    def no_recompute(ctx, g, plain, n_args):
        assert plain is not fa_k.plain, "flash_attention's backward recomputed the plain version"
        return _build_plain_backward(ctx, g, plain, n_args)

    _build_plain_backward = _build.plain_backward
    monkeypatch.setattr(_build, "plain_backward", no_recompute)
    dt = getattr(torch, dtype)
    atol, rtol = _tol(dtype)
    g = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn((B, Hq, Sq, D), generator=g, device="cuda").to(dt)
    k = torch.randn((B, Hkv, Skv, D), generator=g, device="cuda").to(dt)
    v = torch.randn((B, Hkv, Skv, D), generator=g, device="cuda").to(dt)
    go = torch.randn((B, Hq, Sq, D), generator=g, device="cuda").to(dt)
    kw = dict(causal=causal, logit_soft_cap=cap)
    before = fa_k.launches_bwd
    got = _grads(q, k, v, go, fa_k.flash_attention, **kw)
    torch.cuda.synchronize()
    assert fa_k.launches_bwd == before + 1
    again = _grads(q, k, v, go, fa_k.flash_attention, **kw)
    want = _grads(q, k, v, go, fa_k.plain, **kw)
    with torch.no_grad():
        out, lse, out_lo = fa_k._launch(q, k, v, causal, 1.0 / D ** 0.5, cap, True)
        if out_lo is not None:                     # bf16: the float32 output
            out = out.float() + out_lo.float()
        mine = fa_k.plain_bwd(q, k, v, out, lse, go, **kw)
    for name, a, b, w, p in zip("qkv", got, again, want, mine):
        assert a.dtype == dt and torch.equal(a, b), f"d{name} differs between two calls"
        torch.testing.assert_close(a, w, atol=atol, rtol=rtol, msg=lambda m: f"d{name}: {m}")
        torch.testing.assert_close(a, p, atol=atol, rtol=rtol, msg=lambda m: f"d{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_backward_for_one_input_on_card(dtype):
    """Only the inputs that need a gradient get one: k alone, then q
    alone, each equal to plain autograd's."""
    _card()
    dt = getattr(torch, dtype)
    atol, rtol = _tol(dtype)
    g = torch.Generator(device="cuda").manual_seed(12)
    q, go = (torch.randn((2, 32, 130, 128), generator=g, device="cuda").to(dt) for _ in "qg")
    k, v = (torch.randn((2, 8, 130, 128), generator=g, device="cuda").to(dt) for _ in "kv")
    want = _grads(q, k, v, go, fa_k.plain)
    for i in range(3):
        ins = [t.detach().clone().requires_grad_(j == i) for j, t in enumerate((q, k, v))]
        out = fa_k.flash_attention(*ins)
        got, = torch.autograd.grad(out, ins[i], go)
        torch.testing.assert_close(got, want[i], atol=atol, rtol=rtol)
        assert all(t.grad is None for t in ins)


# paged attention at (Hq, Hkv, D): every head group the kernel takes
PAGED_HEADS = [
    (4, 2, 16),       # smoke: G 2
    (4, 4, 16),       # G 1
    (32, 8, 128),     # minitron-8b: G 4
    (48, 8, 128),     # grok: G 6
    (64, 8, 128),     # deepseek-67b: G 8
    (48, 1, 128),     # granite-20b: G 48
    (32, 32, 112),    # D 112, G 1
    (16, 16, 256),    # gemma-7b: D 256, G 1
    (16, 2, 256),     # D 256, G 8
    (8, 2, 8),        # deepseek-67b's smoke: D 8, G 4
]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "float8_e4m3fn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,D", PAGED_HEADS)
def test_paged_attention_split_matches_plain_on_card(dtype, kv, Hq, Hkv, D):
    """Both bodies of the split paged kernel against the plain version:
    ragged kv_len from 1 to the table's length, rolled-out offsets, two
    slots sharing a prefix page, a parked slot (kv_len 1 on an all-zero
    row), garbage in the trash page and in dead pages, with and without a
    soft cap; one call, one count."""
    _card()
    dt = getattr(torch, dtype)
    atol, rtol = _tol(dtype)
    g = torch.Generator(device="cuda").manual_seed(13)
    B, page, n_pages, P = 9, 16, 16, 150
    lens = torch.tensor([1, 2, 16, 17, 40, 100, 200, 256, 1], dtype=torch.int32, device="cuda")
    poff = torch.tensor([0, 0, 0, 16, 0, 32, 48, 0, 0], dtype=torch.int32, device="cuda")
    bt = torch.randperm(P - 1, generator=g, device="cuda")[:B * n_pages].reshape(B, n_pages) + 1
    bt = bt.to(torch.int32)
    bt[4, :2] = bt[3, :2]                          # a shared prefix
    live = ((lens - poff + page - 1) // page).tolist()
    for b in range(B):
        bt[b, live[b]:] = 0
    bt[8] = 0                                      # parked
    bt = bt.contiguous()
    q = torch.randn((B, Hq, 1, D), generator=g, device="cuda").to(dt)
    kp = torch.randn((P, Hkv, page, D), generator=g, device="cuda")
    vp = torch.randn((P, Hkv, page, D), generator=g, device="cuda")
    kw = dict(block_tables=bt, kv_len=lens, pos_offset=poff)
    if kv is None:
        kp, vp = kp.to(dt), vp.to(dt)
        kp[0], vp[0] = 1e4, -1e4
        counter = "launches"
    else:
        kdt = getattr(torch, kv)
        kp, ks = ref.quantize_kv(kp, kdt)
        vp, vs = ref.quantize_kv(vp, kdt)
        used = {int(p) for p in bt.flatten().tolist()}
        dead = torch.tensor(sorted(set(range(P)) - used) + [0], device="cuda")
        ks[dead], vs[dead] = 1e6, 1e6
        kw.update(k_scales=ks, v_scales=vs)
        counter = "launches_quant"
    for cap in (0.0, 30.0):
        before = getattr(pa_k, counter)
        got = pa_k.paged_attention(q, kp, vp, logit_soft_cap=cap, **kw)
        torch.cuda.synchronize()
        assert getattr(pa_k, counter) == before + 1 and got.dtype == dt
        want = pa_k.plain(q, kp, vp, logit_soft_cap=cap, **kw)
        torch.testing.assert_close(got[:8], want[:8], atol=atol, rtol=rtol)
        assert bool(got[8].isfinite().all())      # the parked slot: finite, discarded


@pytest.mark.cuda
def test_paged_attention_refuses_a_head_shape_it_does_not_take_on_card():
    """A head dim or group the kernel is not built for raises before any
    launch and counts none."""
    _card()
    bt = torch.tensor([[1, 2]], dtype=torch.int32, device="cuda")
    before = pa_k.launches
    for Hq, Hkv, D in ((4, 2, 64), (4, 2, 32), (12, 1, 16)):
        q = torch.randn((1, Hq, 1, D), device="cuda")
        pages = torch.randn((3, Hkv, 16, D), device="cuda")
        with pytest.raises(ValueError, match="built for"):
            pa_k.paged_attention(q, pages, pages, block_tables=bt, kv_len=20)
    assert pa_k.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kv_dtype", [("gemma-7b", "fp32"), ("granite-20b", "fp32"),
                                           ("deepseek-67b", "fp32"), ("deepseek-67b", "int8")])
def test_dense_smoke_configs_serve_on_card_as_on_cpu(arch, kv_dtype):
    """The other dense configs' smoke models (gemma's D 16 with GeGLU, (1+w)
    norms and tied embeddings; granite's MQA; deepseek's D 8, also over
    int8 pages with W4A16 weights) in float32, served on the card through
    the kernels and on the CPU through the plain versions with the same
    weights: greedy streams identical through generate() and the paged
    batcher."""
    _card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_map
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.quantize import quantize_mlp_tree

    cfg = get_smoke_config(arch).replace(vocab_size=300, vocab_pad_to=64,
                                         compute_dtype="float32")
    params = ServingEngine(cfg, max_seq=96, device="cuda").params
    if kv_dtype != "fp32":
        params = quantize_mlp_tree(params, group_size=64)
    gpu = ServingEngine(cfg, max_seq=96, device="cuda", params=params, kv_dtype=kv_dtype)
    cpu = ServingEngine(cfg, max_seq=96, device="cpu", kv_dtype=kv_dtype,
                        params=tree_map(lambda t: t.cpu(), params))
    prompts = ["hello world", "a prompt longer than one sixteen-token page, twice over", "x"]
    before = (dec_k.launches, pa_k.launches + pa_k.launches_quant)
    try:
        for p in prompts:
            assert gpu.generate(p, max_new_tokens=12).tokens == \
                cpu.generate(p, max_new_tokens=12).tokens
        hg = [gpu.submit(p, max_new_tokens=12) for p in prompts]
        hc = [cpu.submit(p, max_new_tokens=12) for p in prompts]
        for a, c in zip(hg, hc):
            assert a.result(timeout=300).tokens == c.result(timeout=300).tokens
    finally:
        gpu.shutdown()
        cpu.shutdown()
    assert dec_k.launches > before[0] and pa_k.launches + pa_k.launches_quant > before[1]


@pytest.mark.cuda
def test_xlstm_smoke_serves_on_card_as_on_cpu():
    """The xLSTM smoke model (the default local tier) in float32 on the card
    (rmsnorm kernel at its norms) and on the CPU with the same weights:
    greedy streams identical through generate() and the contiguous splice
    batcher with a stateful prefix pool (the repeat is a prefix hit)."""
    _card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_map
    from repro_torch.serving import ServingEngine

    cfg = get_smoke_config("xlstm-125m").replace(vocab_size=300, vocab_pad_to=64,
                                                 compute_dtype="float32")
    gpu = ServingEngine(cfg, max_seq=96, device="cuda")
    cpu = ServingEngine(cfg, max_seq=96, device="cpu",
                        params=tree_map(lambda t: t.cpu(), gpu.params))
    prompts = ["hello world", "a prompt longer than one sixteen-token page, twice over", "x"]
    before = rms_k.launches
    try:
        for p in prompts:
            assert gpu.generate(p, max_new_tokens=12).tokens == \
                cpu.generate(p, max_new_tokens=12).tokens
        outs = []
        for eng in (gpu, cpu):
            res = [h.result(timeout=300) for h in
                   [eng.submit(p, max_new_tokens=12) for p in prompts]]
            res.append(eng.submit(prompts[1], max_new_tokens=12).result(timeout=300))
            outs.append(res)
        for a, c in zip(*outs):
            assert a.tokens == c.tokens and a.prefix_hit_tokens == c.prefix_hit_tokens
        assert outs[0][-1].prefix_hit_tokens > 0 and not gpu.scheduler.batcher.paged
    finally:
        gpu.shutdown()
        cpu.shutdown()
    assert rms_k.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("paged,kv_dtype", [(True, "fp32"), (False, "fp32"), (True, "int8")],
                         ids=["paged-fp32", "contig-fp32", "paged-int8-w4a16"])
def test_speculative_smoke_streams_on_card_as_plain(paged, kv_dtype):
    """Speculative decoding of the small float32 minitron on the card:
    n-gram drafts, a model drafter (the smoke gemma; decode_attention in
    its propose_k) and forced 100% / 0% acceptance through draft_hook all
    give the plain greedy stream, which equals the CPU's."""
    _card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_map
    from repro_torch.serving import ContinuousBatcher, Request, ServingEngine
    from repro_torch.serving.quantize import quantize_mlp_tree

    kw = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
    cfg = get_smoke_config("minitron-8b").replace(**kw)
    small = get_smoke_config("gemma-7b").replace(**kw)
    params = ServingEngine(cfg, max_seq=96, device="cuda").params
    if kv_dtype != "fp32":
        params = quantize_mlp_tree(params, group_size=64)
    dparams = ServingEngine(small, max_seq=96, device="cuda", seed=1).params

    def run(eng, mode="off", hook=None):
        eng.speculative = mode
        cb = ContinuousBatcher(eng, slots=2, max_seq=96, page=16, prefix_pages=24)
        eng.speculative = "off"
        assert cb.spec_mode == mode and cb.paged == paged
        if hook is not None:
            cb.draft_hook = hook(cb.spec_k)
        req = Request(rid="r", prompt_ids=eng.tokenizer.encode("speculative parity prompt"),
                      max_new_tokens=16)
        cb.submit(req)
        cb.run_until_drained()
        return req.output_ids, cb.spec_stats

    gpu = ServingEngine(cfg, max_seq=96, device="cuda", params=params, paged_kv=paged,
                        kv_dtype=kv_dtype, drafter_cfg=small, drafter_params=dparams)
    cpu = ServingEngine(cfg, max_seq=96, device="cpu", paged_kv=paged, kv_dtype=kv_dtype,
                        params=tree_map(lambda t: t.cpu(), params))
    plain, _ = run(cpu)
    assert run(gpu)[0] == plain
    before = dec_k.launches
    got, st = run(gpu, "model")
    assert got == plain and st.spec_ticks > 0 and dec_k.launches > before
    assert run(gpu, "ngram")[0] == plain
    full = lambda k: lambda slot, req: plain[len(req.output_ids):len(req.output_ids) + k]
    zero = lambda k: lambda slot, req: [(t + 1) % 300 for t in full(k)(slot, req)]
    got, st = run(gpu, "ngram", full)
    assert got == plain and st.acceptance_rate == 1.0 and st.tokens_per_tick > 4
    got, st = run(gpu, "ngram", zero)
    assert got == plain and st.accepted == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_new_call_site_shapes_on_card(dtype):
    """The kernels at this slice's new shapes: rmsnorm at xLSTM's width 768
    (8 and 16 rows) and the verify window's 40 rows of 4096; awq_matmul
    at M = 40 (group 64); decode attention at the drafter's B = 8, 32/8
    heads of 128 over 256 positions."""
    _card()
    dt = getattr(torch, dtype)
    atol, rtol = _tol(dtype)
    g = torch.Generator(device="cuda").manual_seed(3)

    def rn(*s):
        return torch.randn(s, generator=g, device="cuda").to(dt)

    for rows, width in ((8, 768), (16, 768), (40, 4096)):
        x, w = rn(rows, width), 1 + 0.1 * rn(width)
        torch.testing.assert_close(rms_k.rmsnorm(x, w), rms_k.plain(x, w), atol=atol, rtol=rtol)
    K, N = 4096, 16384
    qw = ref.awq_pack(torch.randint(0, 16, (K, N), generator=g, device="cuda"))
    sc = 0.002 * torch.rand((K // 64, N), generator=g, device="cuda")
    zr = torch.randint(0, 16, (K // 64, N), generator=g, device="cuda").float()
    x = rn(40, K)
    torch.testing.assert_close(awq_k.awq_matmul(x, qw, sc, zr, group_size=64),
                               awq_k.plain(x, qw, sc, zr, group_size=64), atol=atol, rtol=rtol)
    q, k, v = rn(8, 32, 1, 128), rn(8, 8, 256, 128), rn(8, 8, 256, 128)
    kl = torch.tensor([20, 41, 64, 100, 128, 200, 255, 256], dtype=torch.int32, device="cuda")
    torch.testing.assert_close(dec_k.decode_attention(q, k, v, kv_len=kl),
                               dec_k.plain(q, k, v, kv_len=kl), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_rolling_smoke_streams_on_card_as_on_cpu(kv_dtype):
    """Rolling windows of the small float32 minitron (int8 pages with
    W4A16 weights too): a prompt that rolls while it prefills and a
    seeded one that rolls while it decodes give the CPU's tokens, rolls,
    pool high-water and summarizer spans; the paged kernel runs with
    pos_offset > 0."""
    _card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_map
    from repro_torch.serving import (ContinuousBatcher, GenerationParams, Request,
                                     ServingEngine, WindowPolicy)
    from repro_torch.serving.quantize import quantize_mlp_tree

    cfg = get_smoke_config("minitron-8b").replace(vocab_size=300, vocab_pad_to=64,
                                                  compute_dtype="float32")
    pol = WindowPolicy(sink_pages=1, window_pages=2, roll_pages=1)
    params = ServingEngine(cfg, max_seq=96, device="cuda").params
    if kv_dtype != "fp32":
        params = quantize_mlp_tree(params, group_size=64)
    seeded = GenerationParams(max_tokens=70, temperature=0.9, seed=7)
    outs = []
    before = pa_k.launches + pa_k.launches_quant
    for dev, p in (("cuda", params), ("cpu", tree_map(lambda t: t.cpu(), params))):
        eng = ServingEngine(cfg, max_seq=96, device=dev, params=p, kv_dtype=kv_dtype,
                            window_policy=pol)
        spans = []
        submit = eng.span_summarizer.submit
        eng.span_summarizer.submit = lambda rid, ids, f=submit: (
            spans.append((rid, list(ids))), f(rid, ids))
        cb = ContinuousBatcher(eng, slots=2, max_seq=96, prefix_pages=24)
        done = {}
        for rid, ids, gp in (("greedy", list(range(2, 102)), None),
                             ("seeded", eng.tokenizer.encode("rolling on the card"), seeded)):
            cb.submit(Request(rid=rid, prompt_ids=ids, max_new_tokens=70, params=gp,
                              on_done=lambda r: done.update(
                                  {r.rid: (list(r.output_ids), r._rolls)})))
        cb.run_until_drained()
        outs.append((done, cb.rolls, cb.pool_stats().high_water, sorted(spans)))
        eng.shutdown()
    assert outs[0] == outs[1]
    assert outs[0][0]["greedy"][1] >= 3 and outs[0][0]["seeded"][1] >= 2
    assert outs[0][2] <= 2 * pol.cap_pages
    assert pa_k.launches + pa_k.launches_quant > before


@pytest.mark.cuda
@pytest.mark.parametrize("params", [{"max_tokens": 16},
                                    {"max_tokens": 16, "seed": 1234, "temperature": 0.9}],
                         ids=["greedy", "seeded"])
def test_fleet_failover_on_card(params):
    """Two replicas of the small float32 minitron on one card: a replica
    killed after the third token hands the session to the other, and the
    client's stream equals an unkilled run's."""
    _card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving import EngineFleet

    cfg = get_smoke_config("minitron-8b").replace(vocab_size=300, vocab_pad_to=64,
                                                  compute_dtype="float32")
    fleet = EngineFleet.build(cfg, replicas=2, max_seq=96, scheduler_slots=4, device="cuda")
    try:
        fleet.warmup()
        prompt = "failover on the card"
        want = fleet.submit(prompt, params=dict(params)).result(timeout=300)
        assert want.error is None and len(want.tokens) == 16
        streamed, killed, state = [], [], {}

        def on_tok(tid, s):
            streamed.append(tid)
            if not killed and len(streamed) >= 3 and state.get("h") is not None:
                killed.append(state["h"].replica)
                fleet.engines[killed[0]].scheduler.kill("test kill")

        state["h"] = h = fleet.submit(prompt, params=dict(params), on_token=on_tok)
        res = h.result(timeout=300)
        assert res.error is None and h.attempts >= 2 and killed[0] != h.replica
        assert streamed == res.tokens == want.tokens
    finally:
        fleet.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [24, 192])
def test_mla_head_widths_on_card(dtype, D):
    """MLA's K = [K_nope, K_rope] width (192 at full width, 24 at smoke)
    with V zero-padded to it: decode attention (B = 8, 16/16 heads,
    ragged) and the flash forward (whole-prompt prefill, causal and not)
    against the plain versions at an explicit scale, one launch a call;
    a gradient through flash at this D raises rather than falling back."""
    _card()
    dt = getattr(torch, dtype)
    atol, rtol = _tol(dtype)
    g = torch.Generator(device="cuda").manual_seed(11)
    dv, H = (128, 16) if D == 192 else (16, 4)
    sc = D ** -0.5

    def rn(*s):
        return torch.randn(s, generator=g, device="cuda").to(dt)

    q, k, v = rn(8, H, 1, D), rn(8, H, 256, D), rn(8, H, 256, D)
    v[..., dv:] = 0
    kl = torch.tensor([1, 5, 16, 17, 100, 128, 255, 256], dtype=torch.int32, device="cuda")
    before = dec_k.launches
    got = dec_k.decode_attention(q, k, v, kv_len=kl, scale=sc)
    assert dec_k.launches == before + 1
    torch.testing.assert_close(got, dec_k.plain(q, k, v, kv_len=kl, scale=sc),
                               atol=atol, rtol=rtol)
    assert bool((got[..., dv:] == 0).all())
    for sq, skv, causal in ((250, 250, True), (70, 130, True), (100, 90, False)):
        q, k, v = rn(1, H, sq, D), rn(1, H, skv, D), rn(1, H, skv, D)
        before = fa_k.launches
        got = fa_k.flash_attention(q, k, v, causal=causal, scale=sc)
        assert fa_k.launches == before + 1
        torch.testing.assert_close(got, fa_k.plain(q, k, v, causal=causal, scale=sc),
                                   atol=atol, rtol=rtol)
    qg = q.clone().requires_grad_()
    before = (fa_k.launches, fa_k.launches_bwd)
    with pytest.raises(NotImplementedError, match="backward kernel is built for"):
        fa_k.flash_attention(qg, k, v, scale=sc)
    assert (fa_k.launches, fa_k.launches_bwd) == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kv_dtype", [("deepseek-v2-lite-16b", "fp32"),
                                           ("deepseek-v2-lite-16b", "int8"),
                                           ("grok-1-314b", "fp32")])
def test_moe_smoke_configs_serve_on_card_as_on_cpu(arch, kv_dtype):
    """The MoE family's smoke models in float32 (deepseek-v2-lite: MLA at D
    24 over latent pages, a dense first block, shared experts, also over
    int8 latent pages with W4A16 weights; grok-1: GQA 4/2 with raw gates),
    served on the card through the kernels and on the CPU through the plain
    versions with the same weights: greedy streams identical through
    generate() and the paged batcher."""
    _card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_map
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.quantize import quantize_mlp_tree

    cfg = get_smoke_config(arch).replace(vocab_size=300, vocab_pad_to=64,
                                         compute_dtype="float32")
    params = ServingEngine(cfg, max_seq=96, device="cuda").params
    if kv_dtype != "fp32":
        params = quantize_mlp_tree(params, group_size=64)
    gpu = ServingEngine(cfg, max_seq=96, device="cuda", params=params, kv_dtype=kv_dtype)
    cpu = ServingEngine(cfg, max_seq=96, device="cpu", kv_dtype=kv_dtype,
                        params=tree_map(lambda t: t.cpu(), params))
    prompts = ["hello world", "a prompt longer than one sixteen-token page, twice over", "x"]
    before = (dec_k.launches, pa_k.launches + pa_k.launches_quant)
    try:
        for p in prompts:
            assert gpu.generate(p, max_new_tokens=12).tokens == \
                cpu.generate(p, max_new_tokens=12).tokens
        hg = [gpu.submit(p, max_new_tokens=12) for p in prompts]
        hc = [cpu.submit(p, max_new_tokens=12) for p in prompts]
        for a, c in zip(hg, hc):
            assert a.result(timeout=300).tokens == c.result(timeout=300).tokens
    finally:
        gpu.shutdown()
        cpu.shutdown()
    assert dec_k.launches > before[0]
    if not cfg.use_mla:     # MLA decodes through decode_attention over its latent view
        assert pa_k.launches + pa_k.launches_quant > before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", [
    (8, 16, 16, 1, 1500, 64, False),        # whisper's cross attention, a decode step
    (1, 16, 16, 1500, 1500, 64, False),     # whisper's encoder
    (1, 16, 16, 16, 1500, 64, False),       # a prefill piece's cross attention
    (1, 16, 16, 250, 250, 64, True),        # whisper's whole-prompt prefill
    (8, 32, 8, 1, 1601, 128, False)])       # llama-3.2-vision's cross, a decode step
def test_cross_attention_shapes_on_card(dtype, B, Hq, Hkv, Sq, Skv, D, causal):
    """The flash forward at the cross-attention families' shapes against
    the plain version, one launch a call; at D = 64 a gradient raises
    rather than falling back (the backward is not built for it)."""
    _card()
    dt = getattr(torch, dtype)
    atol, rtol = _tol(dtype)
    g = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randn((B, Hq, Sq, D), generator=g, device="cuda").to(dt)
    k, v = (torch.randn((B, Hkv, Skv, D), generator=g, device="cuda").to(dt) for _ in "kv")
    before = fa_k.launches
    got = fa_k.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_k.launches == before + 1
    torch.testing.assert_close(got, fa_k.plain(q, k, v, causal=causal), atol=atol, rtol=rtol)
    if D == 64:
        before = (fa_k.launches, fa_k.launches_bwd)
        with pytest.raises(NotImplementedError, match="backward kernel is built for"):
            fa_k.flash_attention(q.clone().requires_grad_(), k, v, causal=causal)
        assert (fa_k.launches, fa_k.launches_bwd) == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-11b"])
def test_cross_attention_smoke_configs_serve_on_card_as_on_cpu(arch):
    """The encoder-decoder and vision smokes in float32 (D = 16; the
    vision gates set to 0.5), on the card through the kernels and on the
    CPU through the plain versions with the same weights: greedy streams
    identical through generate() and the splice batcher (a repeat is a
    prefix hit), and the model alone with its stub input on the first
    prefill piece, then decode steps, logits within 5e-5."""
    _card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_map
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.pagepool import chunk_plan

    cfg = get_smoke_config(arch).replace(vocab_size=300, vocab_pad_to=64,
                                         compute_dtype="float32")
    gpu = ServingEngine(cfg, max_seq=96, device="cuda")
    if "cross" in gpu.params:
        gpu.params["cross"]["attn"]["gate"].fill_(0.5)
    cpu = ServingEngine(cfg, max_seq=96, device="cpu",
                        params=tree_map(lambda t: t.cpu(), gpu.params))
    prompts = ["hello world", "a prompt longer than one sixteen-token page, twice over", "x"]
    before = (dec_k.launches, fa_k.launches)
    try:
        for p in prompts:
            assert gpu.generate(p, max_new_tokens=12).tokens == \
                cpu.generate(p, max_new_tokens=12).tokens
        for p in prompts + [prompts[1]]:
            a = gpu.submit(p, max_new_tokens=12).result(timeout=300)
            c = cpu.submit(p, max_new_tokens=12).result(timeout=300)
            assert (a.tokens, a.prefix_hit_tokens) == (c.tokens, c.prefix_hit_tokens)
        assert a.prefix_hit_tokens > 0 and not gpu.scheduler.batcher.paged
    finally:
        gpu.shutdown()
        cpu.shutdown()
    assert dec_k.launches > before[0] and fa_k.launches > before[1]
    g = torch.Generator().manual_seed(0)
    key, shape = (("frames", (1, cfg.encoder_seq_len, cfg.d_model)) if cfg.is_encoder_decoder
                  else ("vision", (1, cfg.n_image_tokens, cfg.vision_dim)))
    stub = 0.1 * torch.randn(shape, generator=g)
    ids = torch.randint(3, 259, (1, 37), generator=g)
    out = []
    for eng in (gpu, cpu):
        m, dev = eng.model, eng.device
        cache, off, steps = m.init_cache(1, 96, dev), 0, []
        with torch.inference_mode():
            for i, n in enumerate(chunk_plan(0, ids.shape[1], 16)):
                logits, cache = m.prefill_chunk(eng.params, ids[:, off:off + n].to(dev), cache,
                                                {key: stub.to(dev)} if i == 0 else None)
                off += n
            steps.append(logits.cpu())
            for _ in range(3):
                logits, cache = m.decode_step(eng.params, torch.argmax(logits, -1)[:, None],
                                              cache)
                steps.append(logits.cpu())
        out.append(steps)
    for a, c in zip(*out):
        torch.testing.assert_close(a, c, atol=5e-5, rtol=0)
        assert int(a.argmax()) == int(c.argmax())
