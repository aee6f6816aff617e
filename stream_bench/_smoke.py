"""A cell's spec at the smoke size of its architecture, float32, on the CPU,
for the tests: the harness end to end without a card."""

import dataclasses

SMOKE_MIX = {"pool": 64, "prompt_tokens": {"loguniform": [24, 60]},
             "output_tokens": {"loguniform": [8, 40]}}


def smoke_spec(name: str) -> dict:
    from repro_torch.configs import get_smoke_config
    from stream_bench import run
    spec = run.load(name)
    cfg = dict(spec["cfg"])
    full = cfg["port"]["model"]
    c = get_smoke_config(cfg["port"]["arch"]).replace(
        vocab_size=384, param_dtype="float32", compute_dtype="float32",
        eval_capacity_factor=8.0, norm_eps=full["norm_eps"],
        router_renorm=full["router_renorm"])
    m = {f.name: getattr(c, f.name) for f in dataclasses.fields(c) if f.name != "name"}
    cfg["port"] = dict(cfg["port"], model=m, max_seq=256, slots=4, prefix_cache_pages=64)
    spec["cfg"] = cfg
    spec["mix"] = dict(spec["mix"], **SMOKE_MIX)
    return spec
