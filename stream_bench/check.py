"""Whether what the timed path produced is correct.

After the window has closed and the program's state is freed, for every
request that streamed: its prompt must be the ids the byte tokenizer
gives the text sent; each token frame the relay sealed inside the
request's emit must carry the id the batcher emitted, and must have been
opened by the consumer to the same plaintext, byte for byte; the texts
its caller received through SSE must be those frames' texts, in order,
and as many; and a finished stream's usage chunk must count its tokens
and its prompt (as the HPC tier counts a prompt: its message's
characters). (The byte tokenizer streams text only for ids under 259,
so at the client most pieces are empty: what the client alone can show
is the count, the order and the few byte tokens; the ids themselves are
held at the relay's two ends.) Then a sample of
finished requests drawn from the seed, with the longest among them, is
run through the plain float32 reference, which judges each served token
by how far its logit lies below the reference's best at that position.
The number compared is the mean of those gaps over the sample's tokens.
(The widest gap, kept among the readings, does not tell the bf16
program from the fp8 control: over a vocabulary of 100k and more it is
set by the rare position whose best two logits lie within rounding of
each other, in either precision.) Each number compared is printed beside
its limit.
"""

from __future__ import annotations

import json
import random

import torch

from stream_bench import traffic as traffic_mod

SAMPLE_TOKENS = 400      # served tokens the sample reaches for
SAMPLE_MAX = 8           # requests at most


def relay_sound(frames: list, opened: dict, served: list, texts: list) -> bool:
    """Whether a request's sealed token frames (nonce, plaintext), as far
    as it was served, carry the served ids at consecutive sequence
    numbers, were each opened to the same plaintext, and hold the texts
    its caller received."""
    if len(frames) < len(served):
        return False
    got = []
    for nonce, sealed in frames[:len(served)]:
        if opened.get(nonce) != sealed:
            return False
        got.append(json.loads(sealed))
    seqs = [f["seq"] for f in got]
    return ([f["id"] for f in got] == served and [f["text"] for f in got] == texts
            and seqs == list(range(seqs[0], seqs[0] + len(seqs))))


def pairs(calls, requests, vocab: int, sealed: dict, opened: dict):
    """(call, prompt ids, served ids) of every request that streamed, and
    the counts of requests whose prompt, stream, relayed frames or usage
    differ from what the engine saw and emitted, and of requests served an
    id outside the vocabulary (left out of the pairs: the reference
    cannot read them). A finished stream must be every token the engine
    emitted; one its caller closed at the window's end, the tokens the
    engine emitted before the close."""
    by_ids = {tuple(r.prompt_ids): r for _, r in requests}
    bad = {"prompt": 0, "stream": 0, "relay": 0, "usage": 0, "id": 0}
    out = []
    for c in calls:
        if c.failed or not c.texts:
            continue
        ids = traffic_mod.prompt_ids(c.req.content)
        r = by_ids.get(tuple(ids))
        if r is None:
            bad["prompt"] += 1
            continue
        served = list(r.output_ids)
        if c.cut:
            served = served[:len(c.texts)]
        if c.texts != [traffic_mod.token_text(t) for t in served]:
            bad["stream"] += 1
        if not relay_sound(sealed.get(id(r), []), opened, served, c.texts):
            bad["relay"] += 1
        # the HPC tier bills a prompt by its message's characters
        if not c.cut and (c.usage.get("completion_tokens") != len(c.texts)
                          or c.usage.get("prompt_tokens") != len(c.req.content)):
            bad["usage"] += 1
        if not all(0 <= t < vocab for t in served):
            bad["id"] += 1
            continue
        out.append((c, ids, served))
    return out, bad


def sample(done: list, seed: int) -> list:
    """The longest finished request and others drawn from the seed,
    finished or closed at the window's end, up to ``SAMPLE_TOKENS``
    served tokens. (A cell whose requests outlast the window finishes
    few; the closed ones' served tokens are judged too.)"""
    finished = [i for i, (c, _, _) in enumerate(done) if not c.cut]
    if not finished:
        return []
    first = max(finished, key=lambda i: len(done[i][1]) + len(done[i][2]))
    rest = sorted(i for i in range(len(done)) if i != first and len(done[i][2]) > 1)
    random.Random(int(seed) ^ 0x5EED).shuffle(rest)
    picked, n = [first], len(done[first][2])
    for i in rest:
        if n >= SAMPLE_TOKENS or len(picked) >= SAMPLE_MAX:
            break
        picked.append(i)
        n += len(done[i][2])
    return [done[i] for i in picked]


def judge(ref_mod, model: dict, W, picked: list, *, control: bool = False) -> dict:
    seqs = [ids + served[:-1] for _, ids, served in picked]
    served = [s for _, _, s in picked]
    return ref_mod.judge(model, W, seqs, served, control=control)


def checks(cfg: dict, ref_mod, W, calls, requests, seed: int, failed: int, *,
           sealed: dict, opened: dict, control: bool = False) -> tuple:
    """(name -> {"value", "limit"}, readings): the run is correct when
    every value is at or under its limit. ``readings`` has the judged
    tokens and, with ``control``, the fp8 control's widest gap on the
    same sample (for setting the limit; the benchmark's runs leave it
    off). ``sealed`` and ``opened`` are the relay's frames as the
    :class:`~stream_bench.trace.Recorder` kept them."""
    done, bad = pairs(calls, requests, int(cfg["port"]["model"]["vocab_size"]),
                      sealed, opened)
    picked = sample(done, seed)
    out = {"failed_requests": {"value": failed, "limit": 0},
           "prompt_mismatch": {"value": bad["prompt"], "limit": 0},
           "stream_mismatch": {"value": bad["stream"], "limit": 0},
           "relay_mismatch": {"value": bad["relay"], "limit": 0},
           "usage_mismatch": {"value": bad["usage"], "limit": 0},
           "token_outside_vocab": {"value": bad["id"], "limit": 0},
           # at least one request judged: 0 of them is a failure
           "unjudged": {"value": 0 if picked else 1, "limit": 0}}
    readings = {"judged_requests": len(picked),
                "judged_tokens": sum(len(s) for _, _, s in picked)}
    if picked:
        res = judge(ref_mod, cfg["port"]["model"], W, picked, control=control)
        for k, v in res.items():
            readings[k] = summary(v)
        out["mean_logit_gap"] = {"value": readings["gap"]["mean"],
                                 "limit": cfg["check"]["mean_logit_gap"]}
    return out, readings


def with_control(chk: dict, readings: dict) -> dict:
    """The checks with the fp8 control's mean gap, read on the same sample,
    in the program's place: a control that comes out correct here does
    not separate."""
    out = dict(chk)
    out["mean_logit_gap"] = dict(chk["mean_logit_gap"], value=readings["control_gap"]["mean"])
    return out


def summary(gaps: list) -> dict:
    """The widest gap, the mean gap and the share of positions whose
    token is not the reference's best, over a sample's tokens."""
    g = torch.cat(gaps)
    return {"max": float(g.max()), "mean": float(g.mean()),
            "miss_share": float((g > 0).float().mean())}


def correct(chk: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in chk.values())
