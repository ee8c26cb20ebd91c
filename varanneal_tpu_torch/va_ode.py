"""Reference-compatible module alias: ``varanneal.va_ode`` → here.

Counterpart of ``varanneal_tpu/va_ode.py``. The reference packages the
ODE Annealer as ``varanneal/va_ode.py :: Annealer`` and user scripts
import it as ``from varanneal import va_ode``; with this alias they switch
by changing only the package name::

    from varanneal_tpu_torch import va_ode
    anneal = va_ode.Annealer()          # on the CUDA card

The class is :class:`varanneal_tpu_torch.api.Annealer`.
"""

from varanneal_tpu_torch.api import Annealer  # noqa: F401

__all__ = ["Annealer"]
