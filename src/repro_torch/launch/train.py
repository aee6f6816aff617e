"""Training driver: any --arch on one device, with checkpoint/restart
fault tolerance and a resumable data pipeline (the JAX package's
``launch/train.py``, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --steps 50 --batch 8 \
      --seq 64 --ckpt-dir /tmp/ckpt [--smoke] [--device cpu] [--arch ...]

It trains on the CUDA card unless ``--device`` names another device, and
raises where there is no card. The default arch is the JAX package's,
xlstm-125m (its smoke config under ``--smoke``). Like the JAX driver it
passes no extra inputs: llama-3.2-vision-11b trains without patches (its
cross blocks are skipped), and whisper-medium, whose encoder needs
frames, raises ``ValueError``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.common import flatten
from repro_torch.serving.engine import resolve_device
from repro_torch.training import (AdamWConfig, CheckpointManager, SyntheticLMData,
                                  make_train_step)
from repro_torch.training.train import init_train_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    model = build_model(cfg)
    params, opt = init_train_state(model, 0, device)
    n_params = sum(t.numel() for _, t in flatten(params))
    print(f"arch={cfg.name} params={n_params:,} device={device}")

    oc = AdamWConfig(lr=args.lr, warmup_steps=5, decay_steps=max(args.steps, 10))
    step_fn = make_train_step(model, oc, accum_steps=args.accum)
    data = SyntheticLMData(cfg.vocab_size, args.batch, args.seq)

    start_step = 0
    cm = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if cm and cm.latest_step() is not None:
        tree, aux, start_step = cm.restore(None, {"params": params, "opt": opt})
        params, opt = tree["params"], tree["opt"]
        data.restore(aux["data"])
        print(f"resumed from checkpoint step {start_step}")

    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = data.next()
        params, opt, m = step_fn(params, opt,
                                 {"tokens": torch.from_numpy(batch["tokens"]).to(device)})
        if step % 10 == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            tok_s = (step - start_step + 1) * args.batch * args.seq / max(dt, 1e-9)
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.2f} lr {float(m['lr']):.2e} "
                  f"tok/s {tok_s:,.0f}")
        if cm and (step + 1) % args.ckpt_every == 0:
            cm.save_async(step + 1, {"params": params, "opt": opt},
                          aux={"data": data.state()})
    if cm:
        cm.save(args.steps, {"params": params, "opt": opt},
                aux={"data": data.state()})
        print(f"final checkpoint at step {args.steps} -> {args.ckpt_dir}")


if __name__ == "__main__":
    main()
