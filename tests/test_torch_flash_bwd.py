"""The formulation of the port's flash-attention backward kernel, in plain
float32 PyTorch (``flash_attention.plain_fwd``: out and the row
log-sum-exp; ``flash_attention.plain_bwd``: the gradient from out, lse
and Delta = rowsum(dO o O)), against PyTorch autograd of the plain
version and ``jax.vjp`` of the JAX package's ``repro.kernels.ref.mha``.
Inputs from a numpy seed.

Tolerance: atol 1e-5 + rtol 1e-5, float32 throughout (the same float32
math as autograd's, summed in another order). The backward kernel itself
needs the card; ``tests/test_torch_cuda.py`` holds it against
``plain_bwd`` and plain autograd there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

ATOL = RTOL = 1e-5

# (B, Hq, Hkv, Sq, Skv, D, causal, cap)
CASES = [
    (1, 4, 2, 23, 23, 16, True, 0.0),        # causal, ragged T = 23, G 2
    (2, 4, 4, 30, 12, 16, True, 0.0),        # Skv < Sq: 18 rows see no key, G 1
    (1, 4, 1, 9, 31, 16, True, 0.0),         # Skv > Sq: the offset diagonal, G 4
    (2, 4, 2, 17, 29, 16, False, 0.0),       # non-causal
    (1, 4, 2, 23, 23, 16, True, 30.0),       # soft cap 30
    (1, 2, 2, 20, 20, 16, True, 2.0),        # a cap that bites
    (1, 4, 1, 25, 14, 112, True, 30.0),      # D 112, no-key rows under a cap
    (1, 8, 2, 19, 19, 112, False, 0.0),
    (1, 2, 2, 23, 23, 256, True, 0.0),       # gemma-7b's D 256, G 1
    (2, 4, 2, 30, 12, 256, True, 30.0),      # D 256, no-key rows under a cap
    (1, 8, 2, 23, 23, 8, True, 0.0),         # deepseek-67b's smoke: D 8, G 4
    (1, 4, 1, 17, 29, 8, False, 0.0),        # D 8, non-causal
    (1, 48, 1, 9, 20, 16, True, 0.0),        # granite-20b's G 48
]


def _inputs(case):
    B, Hq, Hkv, Sq, Skv, D, _, _ = case
    r = np.random.default_rng(Sq * 100 + Skv + D)
    return [r.standard_normal(s).astype(np.float32) for s in (
        (B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D), (B, Hq, Sq, D))]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def _jax_vjp(q, k, v, do, causal, cap):
    out, vjp = jax.vjp(lambda a, b, c: jref.mha(a, b, c, causal=causal,
                                                 logit_soft_cap=cap), q, k, v)
    return out, vjp(jnp.asarray(do))


@pytest.mark.parametrize("case", CASES)
def test_plain_bwd_matches_autograd_and_jax(case):
    causal, cap = case[6], case[7]
    q, k, v, do = _inputs(case)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tdo = torch.from_numpy(do)
    out = fa.plain(tq, tk, tv, causal=causal, logit_soft_cap=cap)
    want = torch.autograd.grad(out, (tq, tk, tv), tdo)
    jout, jgrads = _jax_vjp(q, k, v, do, causal, cap)

    o, lse = fa.plain_fwd(tq.detach(), tk.detach(), tv.detach(), causal=causal,
                          logit_soft_cap=cap)
    _close(o, out.detach().numpy())
    _close(o, jout)
    got = fa.plain_bwd(tq.detach(), tk.detach(), tv.detach(), o, lse, tdo, causal=causal,
                       logit_soft_cap=cap)
    for g, w, jw in zip(got, want, jgrads):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close(g, w.numpy())
        _close(g, jw)


@pytest.mark.parametrize("case", CASES)
def test_lse_is_the_reference_logsumexp(case):
    """lse against jax.nn.logsumexp of the reference's masked logits, on
    every row that sees a key; a row that sees none has lse = log(Skv)
    (its softmax is uniform) and its gradient to q is zero."""
    B, Hq, Hkv, Sq, Skv, D, causal, cap = case
    q, k, v, do = _inputs(case)
    scale = 1.0 / np.sqrt(D)
    G = Hq // Hkv
    logits = jnp.einsum("bhgqd,bhkd->bhgqk", jnp.asarray(q).reshape(B, Hkv, G, Sq, D),
                        jnp.asarray(k)) * scale
    if cap > 0:
        logits = cap * jnp.tanh(logits / cap)
    qpos = np.arange(Sq) + Skv - Sq
    mask = (np.arange(Skv)[None, :] <= qpos[:, None]) if causal else np.ones((Sq, Skv), bool)
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask, logits, -jnp.inf), axis=-1))
    want = want.reshape(B, Hq, Sq)
    _, lse = fa.plain_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          logit_soft_cap=cap)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Sq)
    seen = (qpos >= 0) | (not causal)
    _close(lse[:, :, seen], want[:, :, seen])
    if not seen.all():
        _close(lse[:, :, ~seen], np.full((B, Hq, int((~seen).sum())), np.log(Skv),
                                         np.float32))
        o, lse = fa.plain_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal,
                              logit_soft_cap=cap)
        dq, _, dv = fa.plain_bwd(*map(torch.from_numpy, (q, k, v)), o, lse,
                                 torch.from_numpy(do), causal=causal, logit_soft_cap=cap)
        assert torch.all(dq[:, :, ~seen] == 0)


def test_plain_bwd_in_bf16_returns_the_inputs_dtype():
    """bf16 inputs: the math stays float32, the gradients come back in
    bf16, within bf16 rounding of the float32 result."""
    case = CASES[0]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    o, lse = fa.plain_fwd(q, k, v)
    want = fa.plain_bwd(q, k, v, o, lse, do)
    b = [t.bfloat16() for t in (q, k, v, do)]
    ob, lseb = fa.plain_fwd(*b[:3])
    assert ob.dtype == torch.bfloat16 and lseb.dtype == torch.float32
    got = fa.plain_bwd(*b[:3], ob, lseb, b[3])
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w, atol=5e-2, rtol=5e-2)
