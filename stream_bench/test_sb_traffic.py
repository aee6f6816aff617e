"""The traffic generator: seeded, the same lengths whatever the seed, and
prompts the engine tokenizes as the harness does."""

from collections import Counter
import json
from pathlib import Path

import pytest

from stream_bench import traffic

MIXES = sorted(p.stem for p in (Path(__file__).parent / "traffic").glob("*.json"))
SEEDS = (7, 2**31 + 11, 2**33 + 5)


def mix(name):
    return json.loads((Path(__file__).parent / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_traffic(name):
    assert traffic.make(mix(name), 123, 8) == traffic.make(mix(name), 123, 8)


@pytest.mark.parametrize("name", MIXES)
def test_lengths_are_the_same_multiset_across_seeds(name):
    def lengths(t):
        return (Counter((r.n_prompt, r.max_tokens) for r in t.fill),
                Counter(r.n_prompt for r in t.pool),
                Counter(r.max_tokens for r in t.pool))

    base = traffic.make(mix(name), SEEDS[0], 8)
    for s in SEEDS[1:]:
        other = traffic.make(mix(name), s, 8)
        assert Counter(r.max_tokens for r in other.pool) == lengths(base)[2]
        assert sorted(r.max_tokens for r in other.fill) == sorted(r.max_tokens for r in base.fill)
        assert lengths(other)[1] == lengths(base)[1]
        assert [r.content for r in other.pool] != [r.content for r in base.pool]
        # the order of lengths is the same too: every seed does the same work
        assert [r.max_tokens for r in other.pool] == [r.max_tokens for r in base.pool]


@pytest.mark.parametrize("name", MIXES)
def test_every_round_takes_one_length_of_each_band(name):
    m = mix(name)
    t = traffic.make(m, 99, 8)
    strata, outs = m["strata"], sorted(r.max_tokens for r in t.pool)
    per = len(outs) // strata
    band = {}
    for b in range(strata):
        for v in outs[b * per:(b + 1) * per]:
            band.setdefault(v, set()).add(b)
    for r in range(per):
        got = [r_.max_tokens for r_ in t.pool[r * strata:(r + 1) * strata]]
        covered = set()
        for v in got:
            covered |= band[v]
        assert len(covered) == strata


@pytest.mark.parametrize("name", MIXES)
def test_prompts_are_unique_and_counted_as_the_tokenizer_counts(name):
    from repro_torch.serving.tokenizer import ByteTokenizer
    tok = ByteTokenizer(384)
    t = traffic.make(mix(name), 5, 8)
    reqs = t.fill + t.pool
    assert len({r.content for r in reqs}) == len(reqs)
    for r in reqs[:50]:
        ids = tok.encode(r.content)
        assert ids == traffic.prompt_ids(r.content)
        assert len(ids) == r.n_prompt
    for i in range(300):
        assert traffic.token_text(i) == tok.decode_token(i)


def test_residual_life_quantiles():
    # one length L: the residual life is uniform on 1..L
    assert traffic.residual_quantiles([100] * 8, 4) == [13, 38, 63, 88]
    # a longer request is caught in flight more often (length-biased)
    r = traffic.residual_quantiles([10, 1000], 101)
    assert sum(x > 10 for x in r) > 95


def test_loguniform_quantiles():
    q = traffic.quantiles({"loguniform": [64, 512]}, 3)
    assert q == [91, 181, 362]     # 64 x 8 ** (1/6, 3/6, 5/6)
