"""STREAM on PyTorch and CUDA: the port of the JAX package ``repro`` to
an NVIDIA H100, slice by slice (see ROADMAP.md).

Layers:
  repro_torch.core     -- judge, router, relay, planes, summarizer, gateway.
  repro_torch.serving  -- engine, session broker, paged batcher, page pool.
  repro_torch.models   -- dense GQA transformer (minitron-8b).
  repro_torch.kernels  -- hand-written Hopper kernels + plain PyTorch versions.
  repro_torch.configs  -- architecture configs (full + smoke).
  repro_torch.launch   -- serving driver.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; they raise where no sm_90 card is present.
"""

__version__ = "0.1.0"
