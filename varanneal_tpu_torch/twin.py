"""Twin-experiment data for the port (NumPy only).

A copy of ``varanneal_tpu/twin.py`` (``rk4_path``, ``_rk4_np``,
``lorenz96_twin``, ``nakl_np_single``, ``nakl_twin``, ``colpitts_np``,
``colpitts_twin``), so that a seed gives bit-identical data in both
packages without the port importing the JAX package. Data generation is
a host-side loop of tiny steps, so it stays NumPy: the torch model is
never called from it.
"""

import numpy as np


def lorenz96_np(x, F):
    """NumPy Lorenz-96 tendency for a single state vector (D,)."""
    return ((np.roll(x, -1) - np.roll(x, 2)) * np.roll(x, 1) - x + F)


def nakl_np_single(x, p, I):
    """NumPy NaKL tendency for a single state [V, m, h, n]; p as in
    models.nakl; I = injected current."""
    (Cm, gNa, ENa, gK, EK, gL, EL,
     vm, dvm, tm0, tm1, vh, dvh, th0, th1, vn, dvn, tn0, tn1) = p[:19]
    V, m, h, n = x

    def gate(a, va, dva, ta0, ta1):
        th = np.tanh((V - va) / dva)
        return (0.5 * (1 + th) - a) / (ta0 + ta1 * (1 - th * th))

    dV = (gNa * m ** 3 * h * (ENa - V) + gK * n ** 4 * (EK - V)
          + gL * (EL - V) + I) / Cm
    return np.array([dV, gate(m, vm, dvm, tm0, tm1),
                     gate(h, vh, dvh, th0, th1),
                     gate(n, vn, dvn, tn0, tn1)])


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


def nakl_twin(N=3001, dt=0.04, sigma=1.0, seed=7, seg=150, i_max=35.0,
              i_min=0.0, sub=10):
    """NaKL twin data (BASELINE config #3): random-step injected current,
    truth integrated ``sub``x finer than the data grid and subsampled so
    the data is a near-exact ODE solution. Returns dict(traj, V, stim, t,
    sigma). ``i_min < 0`` gives a bipolar drive that probes the I–V curve
    across a wider voltage range."""
    from varanneal_tpu_torch.models.nakl import NAKL_P_TRUE

    rng = np.random.default_rng(seed)
    t = dt * np.arange(N)
    steps = rng.uniform(i_min, i_max, size=N // seg + 2)
    stim = np.interp(np.arange(N), np.arange(len(steps)) * seg, steps)
    stim_f = np.interp(np.arange(N * sub) / sub, np.arange(N), stim)
    p = np.asarray(NAKL_P_TRUE)
    x = np.array([-65.0, 0.1, 0.6, 0.3])
    out = [x.copy()]
    h = dt / sub
    for i in range((N - 1) * sub):
        I = stim_f[i]
        fnp = lambda xx: nakl_np_single(xx, p, I)      # noqa: E731
        k1 = fnp(x)
        k2 = fnp(x + h / 2 * k1)
        k3 = fnp(x + h / 2 * k2)
        k4 = fnp(x + h * k3)
        x = x + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(x.copy())
    traj = np.asarray(out)[::sub]
    V = traj[:, 0:1] + sigma * rng.normal(size=(N, 1))
    return dict(traj=traj, V=V, stim=stim, t=t, sigma=sigma)


def colpitts_np(x, p):
    """NumPy Colpitts tendency for a single state (3,); p as in
    models.colpitts."""
    alpha, gamma, q, eta = p[:4]
    return np.array([alpha * x[1],
                     -gamma * (x[0] + x[2]) - q * x[1],
                     eta * (x[1] + 1.0 - np.exp(-x[0]))])


def colpitts_twin(N_data=801, dt=0.05, sigma=0.05, seed=11, spin=4000,
                  Lidx=(0,)):
    """Colpitts twin data: the chaotic attractor at the standard operating
    point, x1 observed (the literature's choice) with additive Gaussian
    noise. Returns dict(traj, Y, t, Lidx, RM, sigma, dt)."""
    from varanneal_tpu_torch.models.colpitts import COLPITTS_P_TRUE

    rng = np.random.default_rng(seed)
    p = np.asarray(COLPITTS_P_TRUE)
    fnp = lambda x: colpitts_np(x, p)                  # noqa: E731
    x0 = _rk4_np(fnp, np.array([0.1, 0.1, 0.1]), dt, spin)[-1]
    traj = _rk4_np(fnp, x0, dt, N_data - 1)
    Lidx = sorted(Lidx)
    Y = traj[:, Lidx] + sigma * rng.normal(size=(N_data, len(Lidx)))
    t = dt * np.arange(N_data)
    return dict(traj=traj, Y=Y, t=t, Lidx=Lidx, RM=1.0 / sigma ** 2,
                sigma=sigma, dt=dt)
