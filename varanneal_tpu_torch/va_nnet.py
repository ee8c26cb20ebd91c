"""Reference-compatible module alias: ``varanneal.va_nnet`` → here.

Counterpart of ``varanneal_tpu/va_nnet.py``. The reference packages the
feedforward-network Annealer as ``varanneal/va_nnet.py :: Annealer``;
this alias mirrors that path::

    from varanneal_tpu_torch import va_nnet
    ann = va_nnet.Annealer()            # on the CUDA card

The class is :class:`varanneal_tpu_torch.nnet.Annealer` (structure /
activation / input / output setters, ``anneal``, ``predict``, save
helpers mirroring the ODE facade).
"""

from varanneal_tpu_torch.nnet import Annealer  # noqa: F401

__all__ = ["Annealer"]
