"""The NaKL Hodgkin–Huxley neuron (Na + K + leak) in PyTorch: BASELINE
config #3, joint state and parameter estimation from voltage-only data,
driven by an injected current.

Counterpart of ``varanneal_tpu/models/nakl.py`` (``nakl``, ``_gate``,
``_cols``, the constants, ``nakl_param_boxes``, ``nakl_log_model``,
``nakl_ss_gates``, ``nakl_ensemble_inits``). The vector field is plain
torch; the NumPy helpers are copies that keep the reference's RNG call
order, so a saved seed rebuilds the same draws in both packages.

State x = [V, m, h, n] (D = 4). Kinetics use the tanh form

    a_inf(V) = 0.5 * (1 + tanh((V - va) / dva))
    tau_a(V) = ta0 + ta1 * (1 - tanh^2((V - va) / dva))

and dynamics

    C dV/dt = gNa m^3 h (ENa - V) + gK n^4 (EK - V) + gL (EL - V) + I_inj(t)
    da/dt   = (a_inf(V) - a) / tau_a(V)        for a in {m, h, n}

Parameter vector (NP = 19), in order:

    [Cm, gNa, ENa, gK, EK, gL, EL,
     vm, dvm, tm0, tm1,  vh, dvh, th0, th1,  vn, dvn, tn0, tn1]

The injected current is the stimulus: the model is called as
``nakl(t, x, (p, stim))`` with stim of shape (..., S), column 0 the
current. The hand-written device functions of the same field (f, Jᵀv
and the parameter adjoint) are in ``kernels/csrc/nakl.cuh``.
"""

import numpy as np
import torch

NAKL_PNAMES = (
    "Cm", "gNa", "ENa", "gK", "EK", "gL", "EL",
    "vm", "dvm", "tm0", "tm1",
    "vh", "dvh", "th0", "th1",
    "vn", "dvn", "tn0", "tn1",
)

# The standard twin-experiment truth values.
NAKL_P_TRUE = (
    1.0, 120.0, 50.0, 20.0, -77.0, 0.3, -54.4,
    -40.0, 15.0, 0.1, 0.4,
    -60.0, -15.0, 1.0, 7.0,
    -55.0, 30.0, 1.0, 5.0,
)

# Wide per-parameter estimation boxes (order = NAKL_PNAMES; truth well
# inside every box), the campaign's constants.
NAKL_PBOUNDS = (
    (0.5, 3.0),      # Cm
    (50., 200.),     # gNa
    (20., 80.),      # ENa
    (5., 60.),       # gK
    (-100., -50.),   # EK
    (0.05, 1.0),     # gL
    (-75., -40.),    # EL
    (-60., -20.),    # vm
    (5., 30.),       # dvm
    (0.05, 1.0),     # tm0
    (0.1, 2.0),      # tm1
    (-80., -40.),    # vh
    (-30., -5.),     # dvh
    (0.1, 5.0),      # th0
    (1., 15.),       # th1
    (-75., -35.),    # vn
    (10., 50.),      # dvn
    (0.1, 5.0),      # tn0
    (1., 15.),       # tn1
)

# Index groups (into NAKL_PNAMES) for log-space estimation: the six gate
# timescales and the three conductances, all positive scale parameters.
NAKL_TAU_IDX = (9, 10, 13, 14, 17, 18)
NAKL_G_IDX = (1, 3, 5)                      # gNa, gK, gL

NAKL_STATE_BOUNDS = ((-150., 70.), (0., 1.), (0., 1.), (0., 1.))


def nakl_param_boxes(p_idx, *, log_tau=False, log_g=False,
                     box_shrink=1.0, box_offset=0.5,
                     box_shrink_all=False, seed=0):
    """Estimation-scale parameter boxes for the NaKL twin experiment.

    Returns ``(pbounds, log_idx)``: one ``(lo, hi)`` per entry of
    ``p_idx`` (indices into ``NAKL_PNAMES``), on the scale the decision
    vector carries (log for timescales/conductances when
    ``log_tau``/``log_g``), and the tuple of indices estimated in log
    space. ``box_shrink > 1`` shrinks the kinetics and reversal boxes by
    that factor around an offset-jittered center near truth (offsets up
    to ``box_offset`` half-widths from ``default_rng(seed + 777)``),
    keeping Cm and the conductances wide unless ``box_shrink_all``."""
    p_idx = list(p_idx)
    pbounds = [NAKL_PBOUNDS[j] for j in p_idx]
    log_idx = tuple((NAKL_TAU_IDX if log_tau else ())
                    + (NAKL_G_IDX if log_g else ()))
    if log_idx:
        pbounds = [(np.log(b[0]), np.log(b[1])) if pi in log_idx else b
                   for b, pi in zip(pbounds, p_idx)]
    if box_shrink != 1.0:
        S = float(box_shrink)
        keep_wide = () if box_shrink_all else (0,) + NAKL_G_IDX
        p_tr = np.asarray(NAKL_P_TRUE, np.float64)[p_idx].copy()
        log_loc = [j for j, pi in enumerate(p_idx) if pi in log_idx]
        if log_loc:
            p_tr[log_loc] = np.log(p_tr[log_loc])
        rng_box = np.random.default_rng(seed + 777)
        off = rng_box.uniform(-box_offset, box_offset, len(p_idx))
        shr = []
        for j, (pi, (b0, b1), c) in enumerate(zip(p_idx, pbounds, p_tr)):
            if pi in keep_wide:
                shr.append((b0, b1))
                continue
            w = (b1 - b0) / (2.0 * S)
            c = c + off[j] * w
            shr.append((max(b0, c - w), min(b1, c + w)))
        pbounds = shr
    return pbounds, log_idx


def _cols(p, idx):
    """Columns ``idx`` of p: scalars for a (NP,) vector, else (..., 1)
    slices that broadcast against x (..., D)."""
    if p.ndim == 1:
        return [p[j] for j in idx]
    return [p[..., j:j + 1] for j in idx]


def _gate(V, a, va, dva, ta0, ta1):
    th = torch.tanh((V - va) / dva)
    a_inf = 0.5 * (1.0 + th)
    tau_a = ta0 + ta1 * (1.0 - th * th)
    return (a_inf - a) / tau_a


def nakl(t, x, p):
    """NaKL vector field. ``p`` is ``(params, stim)`` when driven."""
    if isinstance(p, tuple):
        p, stim = p
        Iinj = stim[..., 0:1]
    else:
        Iinj = 0.0
    (Cm, gNa, ENa, gK, EK, gL, EL,
     vm, dvm, tm0, tm1, vh, dvh, th0, th1, vn, dvn, tn0, tn1) = _cols(
        p, range(19))

    V = x[..., 0:1]
    m = x[..., 1:2]
    h = x[..., 2:3]
    n = x[..., 3:4]

    dV = (gNa * m ** 3 * h * (ENa - V)
          + gK * n ** 4 * (EK - V)
          + gL * (EL - V) + Iinj) / Cm
    dm = _gate(V, m, vm, dvm, tm0, tm1)
    dh = _gate(V, h, vh, dvh, th0, th1)
    dn = _gate(V, n, vn, dvn, tn0, tn1)
    return torch.cat([dV, dm, dh, dn], dim=-1)


def nakl_log_model(log_idx):
    """Log-space estimation: ``(model_f, P_base)``, a model that
    exponentiates the parameter coordinates ``log_idx`` before the NaKL
    dynamics, and the truth vector with those coordinates logged (the
    estimation-scale base for ``build_spec(P=...)``). An empty
    ``log_idx`` returns :func:`nakl` itself, so that K6's envelope
    recognises the campaign's default model. ``model_f.log_idx`` and
    ``model_f.base`` name the coordinates and the model it wraps
    (``kernels.fe`` exponentiates them outside its kernels)."""
    P_base = np.asarray(NAKL_P_TRUE, dtype=np.float64).copy()
    if not log_idx:
        return nakl, P_base
    log_idx = tuple(int(i) for i in log_idx)
    P_base[list(log_idx)] = np.log(P_base[list(log_idx)])
    cols = list(log_idx)

    def model_f(t, x, p):
        pp, st = p if isinstance(p, tuple) else (p, None)
        pl = pp.clone()
        pl[..., cols] = torch.exp(pp[..., cols])
        return nakl(t, x, pl if st is None else (pl, st))

    model_f.log_idx = log_idx
    model_f.base = nakl
    return model_f, P_base


def nakl_ss_gates(V_f, p=NAKL_P_TRUE):
    """Steady-state gate paths slaved to a voltage trace: [m_inf(V),
    h_inf(V), n_inf(V)] for the kinetics in full parameter vector ``p``
    (NumPy)."""
    V_f = np.asarray(V_f, np.float64)
    p = np.asarray(p, np.float64)

    def a_inf(va, dva):
        return 0.5 * (1.0 + np.tanh((V_f - va) / dva))

    return [a_inf(p[7], p[8]), a_inf(p[11], p[12]), a_inf(p[15], p[16])]


def nakl_ensemble_inits(rng, B, pbounds, Vfs, *, pidx,
                        gates_random=False, gates_own_ss=False,
                        seed_pool=None, seed_jitter=0.03,
                        dtype=np.float32):
    """The (B, n) packed ensemble of the NaKL campaign recipe: per
    member, a parameter draw (uniform from the estimation boxes, or
    jittered from a ``seed_pool`` of earlier estimates) and per-protocol
    state blocks of the data voltage, steady-state gate paths (slaved to
    the truth kinetics, or to the member's own draw with
    ``gates_own_ss``) and small gate jitter.

    ``Vfs``: per-protocol model-grid voltages (len K, each (N_f,));
    ``pbounds``: estimation-scale boxes for ``pidx``. The RNG call
    sequence is the campaign's reproducibility contract (saved seeds
    rebuild identical draws): do not reorder."""
    n_f = len(Vfs[0])
    gates_ss_truth = [nakl_ss_gates(V_fk) for V_fk in Vfs]
    xp0s = []
    for bi in range(B):
        if seed_pool is not None:
            base_pe = seed_pool[bi % seed_pool.shape[0]]
            pe = [float(np.clip(v + rng.normal(0.0, seed_jitter
                                               * (b[1] - b[0])),
                                b[0], b[1]))
                  for v, b in zip(base_pe, pbounds)]
        else:
            pe = [rng.uniform(*b) for b in pbounds]
        pfull = np.asarray(NAKL_P_TRUE, dtype=np.float64).copy()
        pfull[list(pidx)] = pe
        blocks = []
        for V_fk, gss in zip(Vfs, gates_ss_truth):
            if gates_random:
                gates = [rng.uniform(0, 1, n_f) for _ in range(3)]
            else:
                if gates_own_ss:
                    gss = nakl_ss_gates(V_fk, pfull)
                gates = [np.clip(g + rng.normal(0, 0.05, n_f), 0, 1)
                         for g in gss]
            blocks.append(np.column_stack([V_fk] + gates).ravel())
        xp0s.append(np.concatenate(blocks + [pe]).astype(dtype))
    return np.stack(xp0s)
