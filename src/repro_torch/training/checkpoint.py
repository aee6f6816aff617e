"""Fault-tolerant checkpointing: one ``.npy`` per leaf + a JSON manifest
(the JAX package's ``training/checkpoint.py``, which writes msgpack).

  * atomic: written to ``<dir>.tmp`` then renamed, so a crash mid-save
    never corrupts the latest checkpoint;
  * async: ``save_async`` copies the tree to the host before it returns
    (the train step updates params in place) and writes on a thread;
  * leaves are stored in the port's sorted key-path order
    (``models.common.flatten``) as full logical arrays; a bfloat16 leaf
    as its ``uint16`` bits, its dtype in ``MANIFEST.json``;
  * data-pipeline state and the step ride in the manifest's ``aux``, so a
    preempted job resumes exactly;
  * retention: ``keep_last`` N, never deleting the newest complete one.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from torch.distributed.tensor import distribute_tensor

from repro_torch.models.common import flatten, tree_map, tree_unflatten

MANIFEST = "MANIFEST.json"


def _host_leaves(tree):
    """[(key path, numpy array, torch dtype name)] in flatten order."""
    return [(p, _to_host(t), str(t.dtype).removeprefix("torch."))
            for p, t in flatten(tree)]


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)        # a copy even for a CPU tensor
    if t.dtype == torch.bfloat16:              # numpy has no bfloat16: its bits
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------- paths
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def _complete_steps(self) -> list[int]:
        return sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.dir, n, MANIFEST)))

    def latest_step(self) -> int | None:
        steps = self._complete_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, *, aux: dict | None = None):
        """Blocking save. ``tree`` is a nested dict of tensors."""
        self.wait()
        self._write(step, _host_leaves(tree), aux or {})

    def save_async(self, step: int, tree, *, aux: dict | None = None):
        self.wait()
        host = _host_leaves(tree)                 # device -> host now

        def work():
            try:
                self._write(step, host, aux or {})
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host, aux: dict):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for i, (_, leaf, _) in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), leaf)
        manifest = {
            "step": step,
            "time": time.time(),
            "n_leaves": len(host),
            "paths": ["/".join(p) for p, _, _ in host],
            "dtypes": [dt for _, _, dt in host],
            "shapes": [list(leaf.shape) for _, leaf, _ in host],
            "aux": aux,
        }
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self._complete_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------- restore
    def restore(self, step: int | None, like_tree, *, shardings=None, mesh=None):
        """Restore into the structure of ``like_tree``: each leaf comes back
        with the like leaf's dtype, on its device. With ``shardings`` (a
        tree of placements of the like tree's structure, from
        ``spec_tree_to_shardings``) each leaf is laid out on ``mesh`` as a
        DTensor with its placements, whatever mesh wrote it: an elastic
        restart; ``mesh`` comes only with them. A like leaf may then be a
        ``meta`` tensor (``shape_tree``): its data goes to the mesh's
        device. Returns (tree, aux, step)."""
        if (shardings is None) != (mesh is None):
            raise ValueError("shardings and the mesh they are placements on come together")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        like = flatten(like_tree)
        paths = ["/".join(p) for p, _ in like]
        if manifest["paths"] != paths:
            raise ValueError(f"checkpoint {d} holds {manifest['n_leaves']} leaves that "
                             f"do not match the tree's {len(paths)}")
        leaves = []
        for i, (path, t) in enumerate(like):
            a = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
            if (manifest["dtypes"][i] != str(t.dtype).removeprefix("torch.")
                    or tuple(a.shape) != tuple(t.shape)):
                raise ValueError(f"{'/'.join(path)}: checkpoint {manifest['dtypes'][i]} "
                                 f"{tuple(a.shape)}, tree {t.dtype} {tuple(t.shape)}")
            if mesh is None and t.device.type == "meta":
                raise ValueError(f"{'/'.join(path)}: a meta like leaf needs shardings")
            leaves.append(_from_host(a, t.dtype).to(
                t.device if mesh is None else mesh.device_type))
        tree = tree_unflatten(like_tree, leaves)
        if shardings is not None:
            tree = tree_map(lambda x, pl: distribute_tensor(x, mesh, pl), tree, shardings)
        return tree, manifest["aux"], step
