"""Seeded sampling in the port against the JAX package: Threefry-2x32
keys and random bits bit for bit, ``categorical`` draws token for token,
and sampled serving streams token-identical to the reference engine's.

The random bits are compared exactly. The Gumbel noise is compared as
draws, not values: ``-log(-log(u))`` may differ by an ulp of ``log``
between XLA and PyTorch, which moves no argmax here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.serving import ServingEngine as RefEngine  # noqa: E402
from repro.serving.sampler import SamplerConfig as RefSamplerConfig  # noqa: E402
from repro.serving.sampler import sample_slots as ref_sample_slots  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import GenerationParams, SamplerConfig, ServingEngine  # noqa: E402
from repro_torch.serving import prng  # noqa: E402
from repro_torch.serving.sampler import sample_slots  # noqa: E402

SEEDS = [0, 1, 42, 123456789, 2**31 - 1]
KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
PROMPTS = ["hello paged world", "a prompt that runs past one sixteen-token page, "
           "and then some more", "x"]


def _pair(key):
    return tuple(int(v) for v in np.asarray(key).tolist())


def _t(key):
    return torch.tensor([key[0]]), torch.tensor([key[1]])


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert prng.PRNGKey(seed) == _pair(key)
    for data in (0, 1, 7, 2**31 + 5):
        assert tuple(int(v) for v in prng.fold_in(prng.PRNGKey(seed), data)) == \
            _pair(jax.random.fold_in(key, data))
    for num in (2, 3, 8):
        assert prng.split(prng.PRNGKey(seed), num) == \
            [tuple(r) for r in np.asarray(jax.random.split(key, num)).tolist()]
    # a chain of splits, as the engine walks its key
    k, jk = prng.PRNGKey(seed), key
    for _ in range(5):
        k, sub = prng.split(k)
        jk, jsub = jax.random.split(jk)
        assert (k, sub) == (_pair(jk), _pair(jsub))


@pytest.mark.parametrize("shape", [(1,), (7,), (384,), (4096,), (3, 5)])
def test_random_bits_match_jax(shape):
    n = int(np.prod(shape))
    for seed in SEEDS:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        want = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
        got = prng.random_bits(*_t(_pair(key)), n)[0].reshape(shape)
        np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_draws_match_jax():
    """>= 64 keys over a V=384 row: every draw equal."""
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(96, 384))).astype(np.float32)
    logits[::5, 200:] = -1e30                     # nucleus-masked rows
    keys = [jax.random.fold_in(jax.random.PRNGKey(s), t)
            for s in range(12) for t in range(8)]
    want = np.asarray(jax.vmap(jax.random.categorical)(jnp.stack(keys),
                                                       jnp.asarray(logits)))
    k1 = torch.tensor([_pair(k)[0] for k in keys])
    k2 = torch.tensor([_pair(k)[1] for k in keys])
    got = prng.categorical(k1, k2, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_slots_matches_reference():
    """Mixed batch: greedy, seeded and shared-key slots, top-p < 1."""
    rng = np.random.default_rng(1)
    V = 384
    temps = np.array([0.0, 0.8, 1.0, 0.7, 1.3, 0.0, 0.9, 1.0], np.float32)
    top_ps = np.array([1.0, 0.9, 1.0, 0.5, 0.95, 1.0, 1.0, 0.8], np.float32)
    seeds = np.array([-1, 5, -1, 2**31 - 1, 0, 9, -1, 77], np.int64)
    sc = SamplerConfig(vocab_size=300)
    rsc = RefSamplerConfig(vocab_size=300)
    for tick in range(16):
        logits = (2 * rng.normal(size=(8, V))).astype(np.float32)
        steps = np.full(8, tick, np.int32) + np.arange(8, dtype=np.int32)
        key = jax.random.fold_in(jax.random.PRNGKey(3), tick)
        want = np.asarray(ref_sample_slots(
            jnp.asarray(logits), key, rsc, jnp.asarray(temps), jnp.asarray(top_ps),
            jnp.asarray(seeds, jnp.int32), jnp.asarray(steps)))
        got = sample_slots(torch.from_numpy(logits), _pair(key), sc, temps, top_ps,
                           seeds, steps)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def engines():
    ref = RefEngine(ref_smoke("minitron-8b").replace(**KW), max_seq=96)
    params = jax.tree.map(np.asarray, ref.params)
    port = ServingEngine(get_smoke_config("minitron-8b").replace(**KW), max_seq=96,
                         device="cpu", params=params_from_numpy(params))
    yield ref, port, params
    ref.shutdown()
    port.shutdown()


def test_seeded_submit_streams_equal_reference(engines):
    """Seeded streams (temperature 0.8, top-p 0.9) equal the reference's,
    alone and batched next to other sampled sessions."""
    ref, port, _ = engines
    gp = GenerationParams(max_tokens=10, temperature=0.8, top_p=0.9, seed=1234)
    outs = []
    for eng in (ref, port):
        alone = eng.submit(PROMPTS[1], params=gp).result(timeout=120).tokens
        others = [eng.submit(p, params=GenerationParams(
            max_tokens=10, temperature=1.0, seed=None if i else 99))
            for i, p in enumerate(PROMPTS)]
        mixed = eng.submit(PROMPTS[1], params=gp)
        outs.append((alone, mixed.result(timeout=120).tokens,
                     others[0].result(timeout=120).tokens))
        for h in others[1:]:
            assert len(h.result(timeout=120).tokens) == 10
    (ra, rm, ro), (pa, pm, po) = outs
    assert pa == ra == rm == pm and len(pa) == 10
    assert po == ro                               # seed 99, batched
    assert len(set(pa)) > 1


def test_unseeded_stream_follows_reference_key_schedule(engines):
    """An unseeded sampled session draws with the engine's shared key,
    split once per draw and per tick, folded with its slot: on fresh
    engines the port's stream equals the reference's, through generate()
    and through the batcher."""
    _, _, params = engines
    gp = GenerationParams(max_tokens=9, temperature=1.0)
    streams = []
    for make in (lambda: RefEngine(ref_smoke("minitron-8b").replace(**KW), max_seq=96),
                 lambda: ServingEngine(get_smoke_config("minitron-8b").replace(**KW),
                                       max_seq=96, device="cpu",
                                       params=params_from_numpy(params))):
        eng = make()
        if isinstance(eng, RefEngine):
            eng.params = jax.tree.map(jnp.asarray, params)
        solo = eng.generate(PROMPTS[0], params=gp).tokens
        sub = eng.submit(PROMPTS[2], params=gp).result(timeout=120).tokens
        eng.shutdown()
        streams.append((solo, sub))
    assert streams[0] == streams[1]
    assert len(streams[0][0]) == 9 and len(streams[0][1]) == 9
