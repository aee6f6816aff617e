"""The control of each configuration's correctness check: the reference
put in the program's place in fp8 (the precision below the bf16 the
configurations state) comes out not correct, at a size a test run holds
(width 256, 4 layers, a vocabulary of 8,192) and on three seeds. On the
card it was read at the cells' own sizes (PERF.md). It need not decode:
at each position of the same tokens, the gap of the token the fp8 track
puts first is read, and their mean is put through the run's own check
in the program's place."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from stream_bench import check
from stream_bench.reference import moe_lm
from stream_bench.weights import Weights

CONFIGS = sorted(p.stem for p in (Path(__file__).parent / "configs").glob("*.json"))


def sized(cfg):
    from repro_torch.configs import get_smoke_config
    d, full = 256, cfg["port"]["model"]
    c = get_smoke_config(cfg["port"]["arch"]).replace(
        d_model=d, n_layers=4, vocab_size=8192, vocab_pad_to=128, moe_d_ff=256, d_ff=1024,
        head_dim=d // 4, norm_eps=full["norm_eps"], router_renorm=full["router_renorm"])
    if c.use_mla:
        c = c.replace(kv_lora_rank=d // 2, qk_nope_head_dim=d // 8, qk_rope_head_dim=d // 16,
                      v_head_dim=d // 8)
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 2**40 + 5])
@pytest.mark.parametrize("name", CONFIGS)
def test_the_fp8_control_is_not_correct(name, seed):
    cfg = json.loads((Path(__file__).parent / "configs" / f"{name}.json").read_text())
    m = sized(cfg)
    W = Weights(moe_lm.layout(m), seed=seed, dtype=torch.bfloat16, device="cpu")
    g = torch.Generator().manual_seed(seed)
    seqs = [torch.randint(3, m["vocab_size"], (400,), generator=g).tolist() for _ in range(3)]
    served = [s[50:] + [3] for s in seqs]
    out = moe_lm.judge(m, W, seqs, served, control=True)
    readings = {k: check.summary(v) for k, v in out.items()}
    chk = {"mean_logit_gap": {"value": readings["gap"]["mean"],
                              "limit": cfg["check"]["mean_logit_gap"]}}
    assert not check.correct(check.with_control(chk, readings))
