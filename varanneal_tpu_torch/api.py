"""Annealer facade — the reference-compatible public surface, on the card.

Counterpart of ``varanneal_tpu/api.py`` (``make_lbfgs_options``,
``build_bounds``, ``Annealer``: set_model / set_data / set_data_fromfile
/ anneal / minpaths_X / minpaths_P / save_paths / save_params /
save_action_errors), with the same kwarg vocabulary, the same records
and the same files. ``anneal`` runs the ladder (``anneal.run_ladder``)
with the rung solver that ``kernels.solve.pick_rung_solver`` picks: with
the default ``method='L-BFGS-B'`` and ``solver='auto'`` on the card,
the whole-rung kernel K2 (bounded or not) inside its envelope, else the
generic L-BFGS loop over the action of ``kernels.fe.select_action``.
``compensated=True`` sums the action with the two-float tree
(``ops.action.comp_sum``): ``engine='ag'`` through K4
(``kernels.ag.make_action_ag(compensated=True)``), otherwise the
compensated autograd action, always on the generic loop.
``engine='pallas'`` evaluates the action through the time-blocked FE
kernels K6 (``kernels.fe.make_action_pallas``, any of the four discs;
Lorenz-96, or NaKL with its stimulus) on
the generic loop: under ``solver='auto'`` an explicit engine other than
``'ag'`` pins the generic loop, as in the reference.
``checkpoint_path=``, ``repeats > 1`` and ``snapshot_beta=`` run the
ladder through ``anneal.checkpoint.run_ladder_checkpointed``, and the
snapshot is stored as ``XP_snapshot``.

The device is the constructor's: ``Annealer(device=None)`` means the
CUDA card and raises without one; ``Annealer(device="cpu")`` runs the
plain PyTorch path, where ``solver='auto'`` takes the generic loop, as
the JAX facade does off the TPU. ``anneal``'s signature stays the
reference's.

``method`` takes the reference's inner solvers: 'L-BFGS-B' (default),
'LM'/'GN' (matrix-free Levenberg–Marquardt over
``opt.lm.make_residual_fn``), 'TNC' (truncated Newton with bound
projection) and 'CG'/'NCG' (nonlinear CG, unbounded);
``opt_args['cg_iters']`` sets the LM/TNC inner CG depth. They run on
the generic loop's footing, through the action ``select_action`` picks:
NCG evaluates it (K1 once an evaluation under ``engine='ag'``), LM only
takes its records from it, and TNC takes its Hessian-vector products by
autograd of the records action, the autograd action of the same problem
under 'xla' and 'ag' (the reference's TNC over its 'ag' kernel
differentiates the kernel itself; the port's kernels have no second
derivative). Under ``engine='pallas'`` the records are K6's, so TNC
raises ValueError, as the reference's fails in JAX's forward-mode rule
of ``pallas_call``.

What waits for later slices (ROADMAP.md) raises NotImplementedError
naming its item: ``engine='pallas'`` for a problem outside K6's
envelope (a user model, which needs a hand-written f, Jᵀv and
parameter adjoint: §2a item 3; the error names the condition).

Exit flags are mapped to SciPy-like codes: 0 converged (pgtol or ftol),
1 maxiter exhausted, 2 line-search failure.
"""

import time
from typing import Optional

import numpy as np
import torch

from varanneal_tpu_torch import io as vio
from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.anneal.checkpoint import run_ladder_checkpointed
from varanneal_tpu_torch.anneal.ladder import run_ladder
from varanneal_tpu_torch.kernels import ag
from varanneal_tpu_torch.kernels.fe import select_action
from varanneal_tpu_torch.kernels.solve import pick_rung_solver
from varanneal_tpu_torch.ops.action import make_action, pack
from varanneal_tpu_torch.ops.spec import (_insert_midpoints, _interp_grid,
                                          build_spec, canonical_R)
from varanneal_tpu_torch.opt.lbfgs import LBFGSOptions
from varanneal_tpu_torch.opt.lm import LMOptions, make_residual_fn
from varanneal_tpu_torch.opt.tnc import TNCOptions

_STATUS_TO_SCIPY = np.array([0, 0, 1, 2])  # CONV_GRAD/CONV_FTOL/MAXITER/LS_FAIL


def _np_dtype(dtype):
    """float32 or float64 as NumPy's dtype, from a torch or NumPy dtype."""
    if isinstance(dtype, torch.dtype):
        dtype = {torch.float32: np.float32,
                 torch.float64: np.float64}.get(dtype)
        if dtype is None:
            raise ValueError("dtype must be float32 or float64")
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise ValueError("dtype must be float32 or float64")
    return dtype


def make_lbfgs_options(opt_args: Optional[dict],
                       dtype=np.float64) -> LBFGSOptions:
    """Map a reference-style ``opt_args`` dict (SciPy minimize options) onto
    LBFGSOptions. Accepts maxiter, maxcor/m, maxls, gtol/pgtol, ftol, factr,
    direction and bounded_algo.

    When running in float32, the f64-calibrated default tolerances are
    unresolvable (the solver would stop on round-off immediately), so
    unspecified ftol/pgtol get f32 floors (1e-6 / 1e-4).
    """
    opt_args = dict(opt_args or {})
    kw = {}
    if _np_dtype(dtype) == np.float32:
        kw["ftol"] = 1e-6
        kw["pgtol"] = 1e-4
    if "maxiter" in opt_args:
        kw["maxiter"] = int(opt_args.pop("maxiter"))
    if "maxcor" in opt_args:
        kw["m"] = int(opt_args.pop("maxcor"))
    if "m" in opt_args:
        kw["m"] = int(opt_args.pop("m"))
    if "maxls" in opt_args:
        kw["maxls"] = int(opt_args.pop("maxls"))
    if "gtol" in opt_args:
        kw["pgtol"] = float(opt_args.pop("gtol"))
    if "pgtol" in opt_args:
        kw["pgtol"] = float(opt_args.pop("pgtol"))
    if "factr" in opt_args:
        kw["ftol"] = float(opt_args.pop("factr")) * np.finfo(np.float64).eps
    if "ftol" in opt_args:
        kw["ftol"] = float(opt_args.pop("ftol"))
    if "direction" in opt_args:
        kw["direction"] = str(opt_args.pop("direction"))
    if "bounded_algo" in opt_args:
        kw["bounded_algo"] = str(opt_args.pop("bounded_algo"))
    opt_args.pop("maxfun", None)   # accepted, unused (nfev tracked per solve)
    opt_args.pop("disp", None)
    if opt_args:
        raise ValueError(f"unsupported opt_args: {sorted(opt_args)}")
    return LBFGSOptions(**kw)


def build_bounds(spec, bounds, dtype):
    """Replicate per-variable bounds over every time index (reference bounds
    semantics, SURVEY.md §2): ``bounds`` is a list of D (lo, hi) pairs for
    the state variables followed by NPest pairs for the estimated
    parameters, None for a free side. Returns flat (lower, upper) NumPy
    arrays, ±inf where free, or (None, None)."""
    if bounds is None:
        return None, None
    dtype = _np_dtype(dtype)
    bounds = list(bounds)
    if len(bounds) != spec.D + spec.NPest:
        raise ValueError(
            f"bounds must have D + NPest = {spec.D + spec.NPest} entries, "
            f"got {len(bounds)}")
    inf = np.inf
    lo = np.array([(-inf if b[0] is None else b[0]) for b in bounds], dtype)
    hi = np.array([(inf if b[1] is None else b[1]) for b in bounds], dtype)
    lower = np.tile(lo[: spec.D], spec.N_f)
    upper = np.tile(hi[: spec.D], spec.N_f)
    if spec.NPest:
        rep = spec.N_f if spec.time_dep_p else 1
        lower = np.concatenate([lower, np.tile(lo[spec.D:], rep)])
        upper = np.concatenate([upper, np.tile(hi[spec.D:], rep)])
    return lower, upper


class Annealer:
    """Variational annealing driver for ODE problems (reference-compatible).

    Usage matches the reference::

        ann = Annealer()                        # device=None: the card
        ann.set_model(f, D)
        ann.set_data(data, t=t)                 # data: (N, L) observations
        ann.anneal(X0, P0, alpha, beta_array, RM, RF0, Lidx, Pidx, ...)
        ann.save_paths("paths.npy")
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.f = None
        self.D = None
        self.data = None
        self.t_data = None
        self.stim = None
        self.annealing_run = False

    # ------------------------------------------------------------------
    def set_model(self, f, D):
        """Store the vector field f(t, x, p) (a PyTorch function, vectorized
        over time, as ``varanneal_tpu_torch.models``' are) and the state
        dimension D."""
        self.f = f
        self.D = int(D)

    def set_data(self, data, stim=None, t=None, nstart=0, N=None):
        """Window and store the observation series.

        ``data``: (N_total, L) observed values; ``t``: (N_total,) times
        (required); ``stim``: optional (N_total,) or (N_total, S) stimulus;
        ``nstart``/``N``: window selection (reference semantics)."""
        data = np.asarray(data, dtype=np.float64)
        if data.ndim == 1:
            data = data[:, None]
        if t is None:
            raise ValueError("set_data requires t (time array)")
        t = np.asarray(t, dtype=np.float64)
        N = data.shape[0] - nstart if N is None else int(N)
        sl = slice(nstart, nstart + N)
        self.data = data[sl]
        self.t_data = t[sl]
        if stim is not None:
            stim = np.asarray(stim, dtype=np.float64)
            if stim.ndim == 1:
                stim = stim[:, None]
            self.stim = stim[sl]
        else:
            self.stim = None

    def set_data_fromfile(self, data_file, stim_file=None, nstart=0, N=None):
        """Load data from file; column 0 is time, remaining columns are the
        observed variables (reference convention [M])."""
        raw = vio.load_data(data_file)
        stim = None
        if stim_file is not None:
            sraw = vio.load_data(stim_file)
            stim = sraw[:, 1:] if sraw.ndim == 2 else sraw
        self.set_data(raw[:, 1:], stim=stim, t=raw[:, 0], nstart=nstart, N=N)

    # ------------------------------------------------------------------
    def anneal(self, X0, P0, alpha, beta_array, RM, RF0, Lidx, Pidx=None,
               dt_model=None, init_to_data=True, action="A_gaussian",
               disc="trapezoid", method="L-BFGS-B", bounds=None,
               opt_args=None, adolcID=0, dtype=None, track_paths=True,
               verbose=False, checkpoint_path=None, checkpoint_every=10,
               resume=True, R_time_dependent=None, engine="auto",
               repeats=1, snapshot_beta=None, checkpoint_meta=None,
               compensated=False, RF_max=None, RF_min=None,
               solver="auto"):
        """Run the full precision-annealing ladder.

        The reference's signature (``varanneal_tpu/api.py ::
        Annealer.anneal``), on this Annealer's device. ``dtype``: float32
        or float64 (torch or NumPy); None means
        ``torch.get_default_dtype()``. ``engine``: 'auto', 'xla', 'ag',
        'pallas' (see ``kernels.fe.select_action``). ``RF_max``/``RF_min``:
        per-component cap and floor on RF(β) = max(min(RF0·α^β, RF_max),
        RF_min), the same shapes as RF0. ``solver``: 'auto' (the whole-rung kernel K2
        where ``kernels.solve.solve_preferred`` holds, else the generic
        loop), 'generic' or 'fused' (K2 wherever ``solve_supported`` holds,
        else a warning and the generic loop). ``compensated``,
        ``checkpoint_path``/``checkpoint_every``/``resume``, ``repeats``,
        ``snapshot_beta`` and ``checkpoint_meta`` act as the reference's;
        ``method`` and ``opt_args['cg_iters']`` as the module docstring
        says. The kwargs of the module docstring's list raise
        NotImplementedError."""
        if self.f is None or self.data is None:
            raise RuntimeError("call set_model and set_data before anneal")
        if action != "A_gaussian":
            raise ValueError("only action='A_gaussian' is supported")
        if method not in ("L-BFGS-B", "LBFGS", "LM", "GN", "CG", "NCG",
                          "TNC"):
            raise ValueError(f"unsupported method {method!r}")
        del adolcID
        dtype = _np_dtype(torch.get_default_dtype() if dtype is None
                          else dtype)
        tdtype = torch.float32 if dtype == np.float32 else torch.float64
        device = self.device

        P0 = np.asarray(P0, dtype=np.float64)
        spec = build_spec(
            self.f, self.D, self.data, self.t_data, Lidx, RM, disc=disc,
            P=P0, pidx=Pidx, stim=self.stim, dt_model=dt_model,
            R_time_dependent=R_time_dependent)
        self.spec = spec

        # ---- initial path on the model grid --------------------------
        X0 = np.array(X0, dtype=np.float64, copy=True)
        nskip = spec.obs_stride if disc != "SimpsonHermite" else (
            spec.obs_stride // 2)
        N_base = (spec.N_data - 1) * nskip + 1
        if X0.shape == (spec.N_data, spec.D) and N_base != spec.N_data:
            X0 = _interp_grid(X0, N_base)
        if X0.shape != (N_base, spec.D):
            raise ValueError(
                f"X0 must have shape ({spec.N_data},{spec.D}) or "
                f"({N_base},{spec.D}), got {X0.shape}")
        if init_to_data:
            X0[::nskip, np.asarray(spec.Lidx)] = spec.Y
        if disc == "SimpsonHermite":
            X0 = _insert_midpoints(X0)

        XP0 = np.asarray(pack(spec, X0), dtype=dtype)

        def canon(R, name):
            return canonical_R(R, spec.N_f - 1, spec.D, name,
                               time_dependent=R_time_dependent).astype(dtype)

        rf0 = canon(RF0, "RF0")
        rf_max = None if RF_max is None else canon(RF_max, "RF_max")
        rf_min = None if RF_min is None else canon(RF_min, "RF_min")
        lower, upper = build_bounds(spec, bounds, dtype)
        opt_args = dict(opt_args or {})
        cg_iters = opt_args.pop("cg_iters", None)   # LM/TNC inner-CG depth
        opts = make_lbfgs_options(opt_args, dtype)
        betas = np.asarray(beta_array, dtype=dtype)

        # the kernels' envelopes depend on the rf's shape: gate on the
        # shape the rungs' rf takes once the caps and floors are applied
        rf_shape = np.broadcast(*(r for r in (rf0, rf_max, rf_min)
                                  if r is not None))
        rf_gate = rf0 if rf_shape.ndim == 0 else np.zeros(rf_shape.shape)
        if compensated:
            if engine == "pallas":
                raise ValueError(
                    "compensated=True is implemented on the XLA engine and "
                    "the whole-problem 'ag' kernel (in-kernel two-float "
                    "reductions), not the blocked FE kernel")
            if engine == "ag":
                if not ag.ag_supported(spec, rf_gate, tdtype,
                                       compensated=True):
                    raise ValueError(
                        "engine='ag' unsupported for this problem (disc/rf/"
                        "RM shape/time-dep params/shared memory); the "
                        "compensated XLA engine (engine='auto') serves it")
                act, parts = ag.make_action_ag(spec, device=device,
                                               dtype=tdtype,
                                               compensated=True)
                act.engine = "ag"
            else:
                act, parts = make_action(spec, device=device,
                                         compensated=True)
                act.engine = "xla"
        else:
            act, parts = select_action(spec, rf0, engine=engine,
                                       dtype=tdtype, device=device)
        inner_kw = dict(inner="lbfgs")
        cg_kw = {} if cg_iters is None else dict(cg_iters=int(cg_iters))
        if method in ("LM", "GN"):
            inner_kw = dict(inner="lm",
                            residual_fn=make_residual_fn(spec, device),
                            lm_opts=LMOptions(maxiter=opts.maxiter,
                                              ftol=opts.ftol,
                                              pgtol=opts.pgtol, **cg_kw))
        elif method in ("CG", "NCG"):
            inner_kw = dict(inner="ncg")
        elif method == "TNC":
            inner_kw.update(inner="tnc", tnc_opts=TNCOptions(
                maxiter=opts.maxiter, ftol=opts.ftol, pgtol=opts.pgtol,
                maxls=opts.maxls, **cg_kw))
        rung_solver = pick_rung_solver(
            spec, rf_gate, opts, solver=solver, lower=lower, upper=upper,
            dtype=tdtype, compensated=compensated, engine=engine,
            method=method, device=device)

        t0 = time.time()
        repeats = max(1, int(repeats))
        xp0 = torch.as_tensor(XP0, device=device)
        kw = dict(lower=lower, upper=upper, opts=opts,
                  store_paths=track_paths, rf_max=rf_max, rf_min=rf_min,
                  rung_solver=rung_solver, device=device, **inner_kw)
        if (checkpoint_path is not None or repeats > 1
                or snapshot_beta is not None):
            res = run_ladder_checkpointed(
                act, parts, xp0, betas, rf0, float(alpha),
                ckpt_path=checkpoint_path, save_every=checkpoint_every,
                resume=resume, verbose=verbose, repeats=repeats,
                snapshot_beta=snapshot_beta, meta=checkpoint_meta, **kw)
        else:
            res = run_ladder(act, parts, xp0, betas, rf0, float(alpha), **kw)
        res = type(res)(*(None if v is None else v.detach().cpu().numpy()
                          for v in res))
        t1 = time.time()
        if verbose:
            tot_nfev = int(res.nfev.sum())
            print(f"[varanneal_tpu_torch] ladder of {len(betas)} beta "
                  f"steps: {t1 - t0:.3f} s wall (incl. kernel builds on "
                  f"first use), {tot_nfev} action+grad evals")

        # ---- store results (reference attribute names) ----------------
        self.beta_array = np.asarray(beta_array)
        self.alpha = float(alpha)
        self.A_array = res.A
        self.me_array = res.ME
        self.fe_array = res.FE
        self.exitflags = _STATUS_TO_SCIPY[res.status]
        self.niter_array = res.niter
        self.nfev_array = res.nfev
        self.pgnorm_array = res.pgnorm
        self.XP_final = res.XP
        self.XP_snapshot = res.snapshot
        if track_paths:
            self.minpaths = res.paths
        else:
            self.minpaths = res.XP[None, :]
        self.annealing_run = True
        self.anneal_wall_s = t1 - t0
        return res

    # ------------------------------------------------------------------
    def _check_run(self):
        if not self.annealing_run:
            raise RuntimeError("run anneal() first")

    @property
    def minpaths_X(self):
        self._check_run()
        spec = self.spec
        return self.minpaths[:, : spec.n_state].reshape(
            -1, spec.N_f, spec.D)

    @property
    def minpaths_P(self):
        self._check_run()
        spec = self.spec
        if not spec.NPest:
            return np.zeros((self.minpaths.shape[0], 0))
        pest = self.minpaths[:, spec.n_state:]
        if spec.time_dep_p:
            return pest.reshape(-1, spec.N_f, spec.NPest)
        return pest

    def save_paths(self, filename):
        self._check_run()
        return vio.save_paths(filename, self.minpaths_X,
                              np.asarray(self.spec.t_f))

    def save_params(self, filename):
        self._check_run()
        return vio.save_params(filename, self.minpaths_P,
                               np.asarray(self.spec.t_f))

    def save_action_errors(self, filename):
        self._check_run()
        return vio.save_action_errors(
            filename, self.beta_array, self.A_array, self.me_array,
            self.fe_array)
