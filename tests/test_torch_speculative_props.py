"""``speculative_accept`` in the port: the deterministic-stream form of
rejection sampling. Its draws and acceptance counts are bit-identical to
the JAX package's for the same logits, drafts, keys, seeds and steps
(greedy, seeded, shared-key and mixed slots), and the hypothesis sweeps
of the JAX package's ``tests/test_speculative_props.py`` hold: greedy is
exactly argmax, seeded draws replay the plain stream's (seed, step)
draws, acceptance counts the exact-match prefix, and the unseeded
path's marginals match the target softmax within 0.04. Skips where
hypothesis is not installed, as the JAX package's sweeps do."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("hypothesis", reason="speculative property sweeps need hypothesis")
jnp = jax.numpy

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.serving import sampler as jsampler  # noqa: E402
from repro_torch.serving import prng  # noqa: E402
from repro_torch.serving.sampler import (SamplerConfig, sample_slots,  # noqa: E402
                                         speculative_accept)

V = 40


def accept(logits, drafts, draft_len, rng, sc, temps, top_ps, seeds, steps):
    B = logits.shape[0]
    arr = lambda x, dt: np.broadcast_to(np.asarray(x, dt), (B,)).copy()
    return speculative_accept(torch.from_numpy(np.asarray(logits, np.float32)),
                              torch.from_numpy(np.asarray(drafts, np.int64)),
                              arr(draft_len, np.int64), rng, sc,
                              arr(temps, np.float32), arr(top_ps, np.float32),
                              arr(seeds, np.int64), arr(steps, np.int64))


@pytest.mark.parametrize("temps,seeds", [
    (0.0, -1), (0.9, 7), (0.9, -1), ([0.9, 0.0, 0.7], [5, -1, -1])],
    ids=["greedy", "seeded", "shared-key", "mixed"])
def test_speculative_accept_matches_reference(temps, seeds):
    r = np.random.default_rng(11)
    B, W = 3, 5
    logits = r.normal(size=(B, W, V)).astype(np.float32) * 3
    drafts = logits.argmax(-1)[:, :-1].copy()
    drafts[1, 1] = (drafts[1, 1] + 1) % V
    lens = np.array([4, 3, 0])
    steps = np.array([1, 4, 9])
    g, n = accept(logits, drafts, lens, prng.PRNGKey(3), SamplerConfig(vocab_size=V),
                  temps, 0.95, seeds, steps)
    full = lambda x, dt: jnp.asarray(np.broadcast_to(np.asarray(x), (B,)), dt)
    gj, nj = jsampler.speculative_accept(
        jnp.asarray(logits), jnp.asarray(drafts, jnp.int32), jnp.asarray(lens, jnp.int32),
        jax.random.PRNGKey(3), jsampler.SamplerConfig(vocab_size=V),
        full(temps, jnp.float32), full(0.95, jnp.float32), full(seeds, jnp.int32),
        jnp.asarray(steps, jnp.int32))
    assert g.tolist() == np.asarray(gj).tolist()
    assert n.tolist() == np.asarray(nj).tolist()


SETTINGS = dict(max_examples=8, deadline=None)


@settings(**SETTINGS)
@given(B=st.sampled_from([1, 3]), k=st.sampled_from([1, 3, 5]), seed=st.integers(0, 2**16))
def test_greedy_is_exactly_argmax(B, k, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, k + 1, V)).astype(np.float32)
    drafts = rng.integers(0, V, size=(B, k))
    g, _ = accept(logits, drafts, k, prng.PRNGKey(seed), SamplerConfig(vocab_size=V),
                  0.0, 1.0, -1, 0)
    assert np.array_equal(g.numpy(), logits.argmax(-1))


@settings(**SETTINGS)
@given(B=st.sampled_from([1, 3]), k=st.sampled_from([1, 3, 5]),
       seed=st.integers(0, 2**16), gen=st.integers(0, 50))
def test_seeded_draws_replay_plain_stream(B, k, seed, gen):
    """Window position i consumes exactly the (seed, gen + i) draw plain
    decode would make."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, k + 1, V)).astype(np.float32) * 3
    drafts = rng.integers(0, V, size=(B, k))
    sc = SamplerConfig(vocab_size=V)
    key = prng.PRNGKey(seed + 1)
    g, _ = accept(logits, drafts, k, key, sc, 0.9, 0.95, seed, gen)
    for i in range(k + 1):
        expect = sample_slots(torch.from_numpy(logits[:, i]), prng.fold_in(key, i), sc,
                              np.full(B, 0.9, np.float32), np.full(B, 0.95, np.float32),
                              np.full(B, seed), np.full(B, gen + i))
        assert torch.equal(g[:, i], expect)


@settings(**SETTINGS)
@given(k=st.sampled_from([2, 4]), seed=st.integers(0, 2**16))
def test_acceptance_counts_exact_match_prefix(k, seed):
    rng = np.random.default_rng(seed)
    B = 4
    logits = rng.normal(size=(B, k + 1, V)).astype(np.float32)
    g_ref = logits.argmax(-1)
    drafts = g_ref[:, :-1].copy()
    drafts[1, 0] = (drafts[1, 0] + 1) % V
    if k > 1:
        drafts[2, 1] = (drafts[2, 1] + 1) % V
    lens = np.array([k, k, k, 0])
    _, n_acc = accept(logits, drafts, lens, prng.PRNGKey(seed),
                      SamplerConfig(vocab_size=V), 0.0, 1.0, -1, 0)
    n_acc = n_acc.tolist()
    assert n_acc[0] == k and n_acc[1] == 0 and n_acc[3] == 0
    if k > 1:
        assert n_acc[2] == 1


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**10), temp=st.sampled_from([0.7, 1.0]))
def test_unseeded_marginals_match_target_softmax(seed, temp):
    """Over many shared keys the first emitted token's frequencies match
    the target's tempered softmax: drafts never tilt the distribution."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(1, 3, 8)).astype(np.float32)
    drafts = rng.integers(0, 8, size=(1, 2))
    sc = SamplerConfig(vocab_size=8)
    n = 3000
    keys = prng.split(prng.PRNGKey(seed), n)
    toks = [int(accept(logits, drafts, 2, kk, sc, temp, 1.0, -1, 0)[0][0, 0]) for kk in keys]
    freq = np.bincount(toks, minlength=8) / n
    target = torch.softmax(torch.from_numpy(logits[0, 0]) / temp, -1).numpy()
    np.testing.assert_allclose(freq, target, atol=0.04)
