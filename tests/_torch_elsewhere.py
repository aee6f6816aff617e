"""A tensor on a device no kernel wrapper takes -- neither the CPU, the
meta device (the plain versions run there, as for a FakeTensor) nor a
CUDA card -- for the wrappers' refusal tests: a wrapper subclass that
reports "xpu" and runs no op."""

import torch


class Elsewhere(torch.Tensor):
    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_wrapper_subclass(cls, t.shape, dtype=t.dtype,
                                                   device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"no op runs on this tensor: {func}")


def elsewhere(*shape, dtype=torch.float32):
    return Elsewhere(torch.zeros(shape, dtype=dtype))
