"""Twin-experiment data for the port (NumPy only).

A copy of the Lorenz-96 part of ``varanneal_tpu/twin.py`` (``rk4_path``,
``_rk4_np``, ``lorenz96_twin``), so that a seed gives bit-identical data in
both packages without the port importing the JAX package. Data generation
is a host-side loop of tiny steps, so it stays NumPy: the torch model is
never called from it. The NaKL and Colpitts twins wait for the port of
their models.
"""

import numpy as np


def lorenz96_np(x, F):
    """NumPy Lorenz-96 tendency for a single state vector (D,)."""
    return ((np.roll(x, -1) - np.roll(x, 2)) * np.roll(x, 1) - x + F)


def rk4_path(f, x0, dt, n_steps, p, stim=None, t0=0.0):
    """Integrate dx/dt = f(t, x, p) with classic RK4 from x0 (D,).

    ``f`` follows the model-call convention (vectorized over leading axes)
    on NumPy arrays (e.g. ``tests/oracle.py``'s tendencies); each result is
    converted via np.asarray. ``stim``: optional (n_steps+1, S) held
    constant per step.
    Returns (n_steps+1, D).
    """
    x = np.asarray(x0, float).copy()
    out = [x.copy()]
    t = t0
    for i in range(n_steps):
        def g(xx):
            xb = xx[None, :]
            if stim is not None:
                pp = (np.asarray(p, float),
                      np.asarray(stim[i], float)[None, :])
            else:
                pp = np.asarray(p, float)
            return np.asarray(f(np.asarray([t]), xb, pp))[0]
        k1 = g(x)
        k2 = g(x + dt / 2 * k1)
        k3 = g(x + dt / 2 * k2)
        k4 = g(x + dt * k3)
        x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(x.copy())
        t += dt
    return np.asarray(out)


def _rk4_np(fnp, x0, dt, n_steps):
    """Fast host-side RK4 for a numpy tendency fnp(x) -> dx."""
    x = np.asarray(x0, float).copy()
    out = [x.copy()]
    for _ in range(n_steps):
        k1 = fnp(x)
        k2 = fnp(x + dt / 2 * k1)
        k3 = fnp(x + dt / 2 * k2)
        k4 = fnp(x + dt * k3)
        x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(x.copy())
    return np.asarray(out)


def lorenz96_twin(D=20, N_data=161, dt=0.025, F=8.17, sigma=0.5,
                  n_obs=8, seed=2027, spin=2000):
    """The canonical config (BASELINE config #1): Lorenz-96 twin data.

    Observed indices follow the evenly-spread pattern of the reference's
    bundled example ([M] SURVEY.md appendix: L=8 of D=20 →
    [0,2,5,7,10,12,15,17], generalized here to any D/n_obs).
    Returns dict(traj, Y, t, Lidx, RM, sigma).
    """
    rng = np.random.default_rng(seed)
    fnp = lambda x: lorenz96_np(x, F)            # noqa: E731
    x0 = rng.normal(size=D) + F
    x0 = _rk4_np(fnp, x0, dt, spin)[-1]
    traj = _rk4_np(fnp, x0, dt, N_data - 1)
    # evenly spread observed components: floor(i*D/L) reproduces the
    # reference example's [0,2,5,7,10,12,15,17] for D=20, L=8
    Lidx = sorted(set(int(np.floor(i * D / n_obs)) for i in range(n_obs)))
    Y = traj[:, Lidx] + sigma * rng.normal(size=(N_data, len(Lidx)))
    t = dt * np.arange(N_data)
    return dict(traj=traj, Y=Y, t=t, Lidx=Lidx, RM=1.0 / sigma ** 2,
                sigma=sigma, F=F, dt=dt)
