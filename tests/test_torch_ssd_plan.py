"""The bf16 SSD kernel's decomposition (``csrc/ssd.cu``, ``ssd_cb_kernel``
and ``ssd_sub_kernel``), as a plain float32 model, against the JAX
package's ``repro.kernels.ref.ssd`` and its Pallas ``ssm_scan.ssd`` in
interpret mode (which takes no h0). Inputs from a numpy seed.

The model follows the kernel: a chunk of L steps is cut into
``ssm_scan.sub_chunk(L)``-step sub-chunks, each with its own cumsum of
dt A; C.B is formed once per (batch, sub-chunk); each (batch, head,
sub-chunk) forms its own state S_j and its intra-sub-chunk term M x,
skipping both where every dt is 0; the state entering sub-chunk j is the
chunk's incoming state carried over sub-chunks 0 .. j - 1 in order; y adds
exp(cum) C h_j and D x. With ``pieces`` the float32 operand of each
tensor-core product is cut into bf16 pieces as the kernel cuts it: three
for x o w (the state), two for M and for h_j (y).

Tolerance: the float32 decomposition (no pieces) is held to
``tests/test_torch_ssm.py``'s ``_ssd_close``, max abs error <= 1e-5 *
max(1, max |reference|), on that file's inputs (dt up to 0.2). With bf16
inputs and the pieces, to the checks ``chip_smoke.py`` applies on the
card, on its inputs (dt = 1e-3 + 0.1 U): y (bf16) within atol 1e-2 + rtol
1.6e-2 of the reference's, the float32 state within 1e-5 * max(1, max
|reference|). Over a fully live 256-step chunk with dt up to 0.2 the
float32 reference itself strays past that bound from a float64
evaluation (its exp(cum[t] - cum[s]) subtracts cumsums near -400: 2.1e-5
against 1.4e-5 at one seed), so there the model is held to the float64
evaluation, under the same bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ssm_scan as jscan  # noqa: E402
from repro_torch.kernels import ssm_scan  # noqa: E402

SSD_REL = 1e-5
ATOL, RTOL = 1e-2, 1.6e-2
PIECES = (3, 2, 2)             # x o w, M, h_j


def _bf(t):
    return t.to(torch.bfloat16).float()


def _cut(t, n):
    """t as the sum of n bf16 pieces, each the rounding of what the earlier
    left (n = 0: t itself)."""
    if not n:
        return t
    out, rest = torch.zeros_like(t), t
    for _ in range(n):
        piece = _bf(rest)
        out, rest = out + piece, rest - piece
    return out


def plan_ssd(x, dt, A, B, C, D, *, chunk, h0=None, pieces=(0, 0, 0)):
    """(y, h_final) in float32 as the kernel computes them."""
    b, T, H, P = x.shape
    N = B.shape[-1]
    Q = ssm_scan.sub_chunk(chunk)
    n_sub = chunk // Q
    assert Q and n_sub <= 8 and T % chunk == 0
    px, pm, ph = pieces
    x, dt, B, C = x.float(), dt.float(), B.float(), C.float()
    h = torch.zeros(b, H, P, N) if h0 is None else h0.float().clone()
    y = torch.empty(b, T, H, P)
    tri = torch.ones(Q, Q).tril().bool()
    for c in range(T // chunk):
        subs = []
        for j in range(n_sub):                      # the cluster's blocks, before it syncs
            sl = slice(c * chunk + j * Q, c * chunk + (j + 1) * Q)
            xs, ds, Bs, Cs = x[:, sl], dt[:, sl], B[:, sl], C[:, sl]
            cum = torch.cumsum(ds * A, 1).transpose(1, 2)           # (b, H, Q)
            live = (ds != 0).any(1)                                  # (b, H)
            cb = Cs @ Bs.transpose(1, 2)                             # (b, Q, Q): once for all heads
            seg = torch.where(tri, cum[..., :, None] - cum[..., None, :], 0.0)
            M = torch.where(tri, cb[:, None] * torch.exp(seg) * ds.transpose(1, 2)[:, :, None],
                            0.0)
            y_in = torch.einsum("bhts,bshp->bthp", _cut(M, pm), xs)
            w = torch.exp(cum[..., -1:] - cum) * ds.transpose(1, 2)  # (b, H, Q)
            S = torch.einsum("bshp,bsn->bhpn", _cut(xs * w.transpose(1, 2)[..., None], px), Bs)
            live4 = live[..., None, None]
            subs.append((sl, xs, Cs, cum, torch.where(live4, S, 0.0),
                         torch.exp(cum[..., -1]), torch.where(live[:, None, :, None], y_in, 0.0)))
        for j, (sl, xs, Cs, cum, _, _, y_in) in enumerate(subs):
            hj = h
            for (_, _, _, _, S_i, a_i, _) in subs[:j]:
                hj = a_i[..., None, None] * hj + S_i
            y_out = torch.einsum("btn,bhpn->bthp", Cs, _cut(hj, ph))
            y[:, sl] = y_in + torch.exp(cum).transpose(1, 2)[..., None] * y_out \
                + D[None, None, :, None] * xs
        for (_, _, _, _, S_i, a_i, _) in subs:
            h = a_i[..., None, None] * h + S_i
    return y, h


def _inputs(seed, b, T, H, P, N, *, h0, dead=(), bf16=False, dt_max=0.2):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, T, H, P)).astype(np.float32)
    dt = r.uniform(1e-3, dt_max, (b, T, H)).astype(np.float32)
    for lo, hi in dead:                         # steps with dt = 0 (padding)
        dt[:, lo:hi] = 0.0
    A = -r.uniform(1.0, 16.0, H).astype(np.float32)
    B = r.standard_normal((b, T, N)).astype(np.float32)
    C = r.standard_normal((b, T, N)).astype(np.float32)
    D = r.standard_normal(H).astype(np.float32)
    hh = r.standard_normal((b, H, P, N)).astype(np.float32) if h0 else None
    if bf16:
        x, B, C = (np.asarray(_bf(torch.from_numpy(a))) for a in (x, B, C))
    return x, dt, A, B, C, D, hh


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _ssd_close(got, want):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= SSD_REL * max(1.0, np.abs(want).max()), err


def _bf16_close(got, want):
    got, want = _bf(got), _bf(torch.from_numpy(np.array(want, dtype=np.float32)))
    err = (got - want).abs()
    assert not bool((err > ATOL + RTOL * want.abs()).any()), err.max().item()


# (b, T, H, P, N, chunk, h0, dead steps)
CASES = [
    (2, 48, 3, 16, 16, 16, False, ()),                  # smoke chunk: one sub-chunk a chunk
    (2, 48, 3, 16, 16, 16, True, ((37, 48),)),          # padded tail, three chunks
    (2, 48, 3, 16, 16, 16, True, ((16, 32),)),          # a whole zero sub-chunk (and chunk)
    (1, 96, 3, 16, 16, 48, True, ((20, 32),)),          # 16-step sub-chunks, 3 a chunk
    (1, 256, 4, 64, 64, 256, True, ((32, 256),)),       # zamba2's 32-token piece
    (1, 256, 4, 64, 64, 256, False, ()),                # fully live
    (1, 512, 3, 64, 64, 256, True, ((64, 128),)),       # two chunks, a zero sub-chunk
    (1, 512, 3, 64, 64, 256, False, ((448, 512),)),     # two chunks, zero last sub-chunk
]


@pytest.mark.parametrize("case", CASES)
def test_float32_decomposition_matches_reference(case):
    b, T, H, P, N, chunk, h0, dead = case
    arrays = _inputs(T + chunk + len(dead), b, T, H, P, N, h0=h0, dead=dead)
    yj, hj = jref.ssd(*arrays[:6], chunk=chunk, h0=arrays[6])
    t = _torch(arrays)
    y, h = plan_ssd(*t[:6], chunk=chunk, h0=t[6])
    _ssd_close(y, yj)
    _ssd_close(h, hj)


@pytest.mark.parametrize("case", CASES)
def test_bf16_pieces_meet_the_card_checks(case):
    b, T, H, P, N, chunk, h0, dead = case
    arrays = _inputs(T + chunk + 7, b, T, H, P, N, h0=h0, dead=dead, bf16=True,
                     dt_max=0.101)                          # chip_smoke.py's dt
    yj, hj = jref.ssd(*arrays[:6], chunk=chunk, h0=arrays[6])
    t = _torch(arrays)
    y, h = plan_ssd(*t[:6], chunk=chunk, h0=t[6], pieces=PIECES)
    _bf16_close(y, yj)
    _ssd_close(h, hj)


@pytest.mark.parametrize("pieces", [(0, 0, 0), PIECES])
@pytest.mark.parametrize("seed", [519, 521])
def test_long_live_chunk_against_float64(seed, pieces):
    """A fully live 256-step chunk at dt up to 0.2, where the float32
    reference strays past the bound: the model against the plain version
    evaluated in float64."""
    from repro_torch.kernels import ref
    arrays = _inputs(seed, 1, 256, 4, 64, 64, h0=False, bf16=True)
    t = _torch(arrays)
    y64, h64 = ref.ssd(*(a.double() for a in t[:6]), chunk=256)
    y, h = plan_ssd(*t[:6], chunk=256, pieces=pieces)
    _ssd_close(h, h64.float())
    if pieces == (0, 0, 0):
        _ssd_close(y, y64.float())
    else:
        _bf16_close(y, y64.float())


@pytest.mark.parametrize("chunk,dead", [(16, ()), (32, ((40, 64),)), (64, ((8, 64),))])
def test_decomposition_matches_pallas_kernel_interpreted(chunk, dead):
    """The JAX package's Pallas kernel (interpret mode, h0 None) against
    the model, at sub-chunks of 16 (clusters of 1 and 2) and 64."""
    arrays = _inputs(chunk, 1, 64, 2, 16, 16, h0=False, dead=dead)
    yk, hk = jscan.ssd(*arrays[:6], chunk=chunk, interpret=True)
    y, h = plan_ssd(*_torch(arrays[:6]), chunk=chunk)
    _ssd_close(y, yk)
    _ssd_close(h, hk)


def test_zero_sub_chunk_contributes_nothing():
    """A sub-chunk whose dt are all 0 leaves the state as it found it, and
    its rows' y is exp(0) C h + D x: what the kernel computes when it
    skips the sub-chunk's two products."""
    arrays = _inputs(3, 1, 128, 2, 64, 64, h0=True, dead=((64, 128),))
    x, dt, A, B, C, D, h0 = _torch(arrays)
    y, h = plan_ssd(x, dt, A, B, C, D, chunk=128, h0=h0)
    _, h_live = plan_ssd(x[:, :64], dt[:, :64], A, B[:, :64], C[:, :64], D, chunk=64, h0=h0)
    torch.testing.assert_close(h, h_live, atol=1e-6, rtol=1e-6)
    want = torch.einsum("btn,bhpn->bthp", C[:, 64:], h_live) + D[None, None, :, None] * x[:, 64:]
    torch.testing.assert_close(y[:, 64:], want, atol=1e-5, rtol=1e-5)


def test_sub_chunk_rule_matches_the_source():
    """``ssm_scan.sub_chunk`` mirrors ``csrc/ssd.cu``'s ``sub_chunk``."""
    from pathlib import Path
    src = (Path(ssm_scan.__file__).resolve().parent / "csrc" / "ssd.cu").read_text()
    assert "static int sub_chunk(int L) { return L % 64 == 0 ? 64 : L % 16 == 0 ? 16 : 0; }" \
        in src
    assert [ssm_scan.sub_chunk(L) for L in (16, 32, 48, 64, 128, 256, 512, 40)] == \
        [16, 16, 16, 64, 64, 64, 64, 0]
