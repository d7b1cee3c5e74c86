"""The port's device errors, in a module that imports nothing.

:mod:`goleft_tpu_torch.device` re-exports both classes; they live here so
that the processes that never touch the card (the fleet router, its
supervisor, the federation, the host tools, the retry policy they share)
can name them without importing torch.
"""


class NoCudaDevice(RuntimeError):
    """A CUDA run was asked for (explicitly or by default) and no CUDA
    device is visible."""


class KernelFault(RuntimeError):
    """A kernel did not build, launch or finish on the card: a fault of
    the card or its toolchain, not of the data. The retry policy lets it
    through unretried and unquarantined, so the run fails with it."""
