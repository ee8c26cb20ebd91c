"""Neural-network variational annealing (the ``va_nnet`` path), on the card.

Counterpart of ``varanneal_tpu/nnet.py`` (``ACTIVATIONS``,
``nnet_action_factory``, ``forward``, ``Annealer``). A feedforward
network is trained by treating the layer index as time: the activations
are states, the weights and biases parameters, the layer-to-layer map
the dynamics. The measurement error couples the input layer to the
inputs and the output layer to the labels; the model error is the
layer-transfer residual, annealed from soft to hard:

    FE = (1/N_fe) Σ_{m,l} RF_l ⊙ (x^m_{l+1} − g_l(W_l x^m_l + b_l))²
    ME = (1/N_me) Σ_m [RM_in ⊙ (x^m_0 − u^m)² + RM_out ⊙ (x^m_L − y^m)²]

with N_me = M·(n_0 + n_L) (n_0 drops out with ``clamp_input``) and
N_fe = M·Σ_{l≥1} n_l. The decision variables are the flat vector of
``jax.flatten_util.ravel_pytree`` of the tree ``{"X": [per-layer (M,
n_l) activations], "W": [(n_{l+1}, n_l)], "b": [(n_{l+1},)]}``: the dict
keys sorted (W, X, b), each leaf row-major, X[0] left out under
``clamp_input``. ``pack``/``unravel`` reproduce that order exactly, so a
flat vector, a checkpoint or ``W0``/``b0``/``X0`` means the same thing
in both packages.

The action is batched like the ODE actions (``ops.action``): ``XP`` is
(..., n_dof) and the layer products are ``torch.matmul`` over (B, M,
n_l) and (B, n_l, n_{l+1}), so the port's ladder, its solvers and its
checkpoints take it unchanged. Its gradient comes from autograd; no
kernel computes it (the reference computes it in XLA, outside any
Pallas kernel). On the card in f32 the L-BFGS loop that ``direction=
'auto'`` picks runs the direction kernels (K7b in the fused loop, K7a
in the projection loop with ``bounds_W``) where ``kernels.dir.
dir_supported`` holds, that is with a history of m <= 7 (``maxcor``);
with SciPy's default of 10 it is the compact loop, as in the reference.
"""

from typing import Callable, Sequence

import numpy as np
import torch

from varanneal_tpu_torch import io as vio
from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.anneal.checkpoint import run_ladder_checkpointed
from varanneal_tpu_torch.anneal.ladder import run_ladder
from varanneal_tpu_torch.api import (_STATUS_TO_SCIPY, _np_dtype,
                                     make_lbfgs_options)

ACTIVATIONS = {
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "linear": lambda z: z,
}


def _layout(structure, M, clamp_input):
    """The flat vector's leaves in ``ravel_pytree``'s order: (key, index,
    shape, offset) for W[0..L-2], X[0 or 1..L-1], b[0..L-2]."""
    L = len(structure)
    leaves = ([("W", i, (structure[i + 1], structure[i]))
               for i in range(L - 1)]
              + [("X", j, (M, n)) for j, n in
                 enumerate(structure[1:] if clamp_input else structure)]
              + [("b", i, (structure[i + 1],)) for i in range(L - 1)])
    out, off = [], 0
    for key, i, shape in leaves:
        out.append((key, i, shape, off))
        off += int(np.prod(shape))
    return out


def nnet_action_factory(structure: Sequence[int], g: Callable,
                        g_out: Callable, U: np.ndarray, Y: np.ndarray,
                        RM_in, RM_out, *, clamp_input: bool = False,
                        dtype=np.float64, device=None):
    """Build (action, action_parts, pack, unravel) for an nnet VA problem.

    ``structure``: layer widths (n_0, ..., n_L). ``U``: (M, n_0) inputs;
    ``Y``: (M, n_L) targets. ``g``/``g_out``: hidden/output activations
    (torch functions). ``RM_in``/``RM_out``: scalar or per-component
    (n_0,)/(n_L,) weights. ``action(XP, rf)`` and ``action_parts(XP, rf)
    -> (A, ME, FE)`` take XP (..., n_dof) on ``device`` and give one value
    per leading index; ``rf`` is a scalar or per-layer (L-1,). ``pack(tree)``
    flattens a tree of array-likes into a NumPy array of ``dtype``;
    ``unravel(XP)`` gives the tree of an (..., n_dof) array or tensor,
    X[0] left out under ``clamp_input``. ``device=None`` means the CUDA
    card."""
    structure = tuple(int(n) for n in structure)
    L = len(structure)
    M = U.shape[0]
    device = resolve_device(device)
    np_dt = _np_dtype(dtype)
    layout = _layout(structure, M, clamp_input)
    n_me = M * ((0 if clamp_input else structure[0]) + structure[-1])
    n_fe = M * sum(structure[1:])
    consts64 = [np.asarray(a, np.float64) for a in (U, Y, RM_in, RM_out)]
    cache = {}

    def consts(dt):
        if dt not in cache:
            cache[dt] = [torch.as_tensor(a, device=device).to(dt)
                         for a in consts64]
        return cache[dt]

    def pack(tree):
        return np.concatenate([np.asarray(tree[key][i], np_dt).ravel()
                               for key, i, _, _ in layout])

    def unravel(XP):
        lead = tuple(XP.shape[:-1])
        tree = {"X": [], "W": [], "b": []}
        for key, _, shape, off in layout:
            size = int(np.prod(shape))
            tree[key].append(XP[..., off: off + size].reshape(lead + shape))
        return tree

    def action_parts(XP, rf):
        if XP.device != device:
            raise ValueError(f"XP is on {XP.device}, the action on {device}")
        U_, Y_, rm_in, rm_out = consts(XP.dtype)
        tree = unravel(XP)
        X = ([U_] if clamp_input else []) + tree["X"]
        W, b = tree["W"], tree["b"]
        me = torch.sum(rm_out * (X[-1] - Y_) ** 2, dim=(-2, -1))
        if not clamp_input:
            me = me + torch.sum(rm_in * (X[0] - U_) ** 2, dim=(-2, -1))
        me = me / n_me
        # layer-transfer model error; rf scalar or per-layer (L-1,)
        if isinstance(rf, torch.Tensor):
            rf = rf.to(device=device, dtype=XP.dtype)
        elif np.ndim(rf):
            rf = torch.as_tensor(np.asarray(rf, np.float64),
                                 device=device).to(XP.dtype)
        else:
            rf = float(torch.tensor(float(rf), dtype=XP.dtype))
        fe = torch.zeros(XP.shape[:-1], dtype=XP.dtype, device=device)
        for l in range(L - 1):
            act = g_out if l == L - 2 else g
            pred = act(torch.matmul(X[l], W[l].transpose(-1, -2))
                       + b[l][..., None, :])
            r = X[l + 1] - pred
            w = rf if not isinstance(rf, torch.Tensor) or rf.ndim == 0 \
                else rf[l]
            fe = fe + torch.sum(w * r * r, dim=(-2, -1))
        fe = fe / n_fe
        return me + fe, me, fe

    def action(XP, rf):
        return action_parts(XP, rf)[0]

    return action, action_parts, pack, unravel


def forward(structure, g, g_out, W, b, U, *, dtype=None, device=None):
    """Plain forward propagation (the β→∞ limit of the annealed net) on
    ``device`` (None: the CUDA card). Returns a tensor there, in ``dtype``;
    None means torch's default dtype, the reference's rule (its inputs
    take JAX's default dtype under its x64 flag)."""
    device = resolve_device(device)
    dt = torch.get_default_dtype() if dtype is None else dtype

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)
    x = t(U)
    L = len(structure)
    for l in range(L - 1):
        act = g_out if l == L - 2 else g
        x = act(x @ t(W[l]).T + t(b[l]))
    return x


class Annealer:
    """va_nnet-compatible facade, on the card.

    Usage::

        ann = nnet.Annealer()                 # device=None: the card
        ann.set_structure([2, 8, 1])
        ann.set_activation('tanh')            # hidden layers
        ann.set_input_data(U); ann.set_output_data(Y)
        ann.anneal(alpha=1.5, beta_array=range(30), RM=1.0, RF0=1e-4)

    ``Annealer(device="cpu")`` runs the plain PyTorch path.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.structure = None
        self.g = ACTIVATIONS["tanh"]
        self.g_out = ACTIVATIONS["linear"]
        self.U = None
        self.Y = None
        self.annealing_run = False

    def set_structure(self, structure):
        self.structure = tuple(int(n) for n in structure)

    def set_activation(self, g, g_out=None):
        """Hidden activation (torch callable or name); the output activation
        defaults to linear (the reference's regression setup [M])."""
        self.g = ACTIVATIONS[g] if isinstance(g, str) else g
        if g_out is not None:
            self.g_out = (ACTIVATIONS[g_out] if isinstance(g_out, str)
                          else g_out)

    def set_input_data(self, data_in):
        self.U = np.asarray(data_in, np.float64)

    def set_output_data(self, data_out):
        self.Y = np.asarray(data_out, np.float64)

    def anneal(self, alpha, beta_array, RM, RF0, *, W0=None, b0=None,
               X0=None, clamp_input=False, bounds_W=None, opt_args=None,
               adolcID=0, dtype=None, track_paths=True, seed=0,
               init_scale=0.1, checkpoint_path=None, checkpoint_every=10,
               resume=True):
        """Run the ladder on this Annealer's device. RM: scalar or (RM_in,
        RM_out) pair; RF0: scalar or per-layer (L-1,). W0/b0/X0: initial
        weights/biases/activations (defaults: Gaussian ``init_scale``
        weights from ``np.random.default_rng(seed)``, zero biases,
        activations forward-propagated from the inputs, each layer's
        product in float64 and its activation in ``dtype``, as the
        reference forms them). ``bounds_W=(lo, hi)`` bounds the weights
        only. ``dtype``: float32 or float64, None meaning
        ``torch.get_default_dtype()``. ``checkpoint_path``/
        ``checkpoint_every``/``resume``: per-chunk checkpoints of the flat
        vector (``anneal/checkpoint.py``)."""
        if self.structure is None or self.U is None or self.Y is None:
            raise RuntimeError(
                "call set_structure / set_input_data / set_output_data first")
        del adolcID
        dtype = _np_dtype(torch.get_default_dtype() if dtype is None
                          else dtype)
        tdtype = torch.float32 if dtype == np.float32 else torch.float64
        device = self.device
        structure, L = self.structure, len(self.structure)
        M = self.U.shape[0]
        if self.U.shape[1] != structure[0]:
            raise ValueError("input data width != structure[0]")
        if self.Y.shape != (M, structure[-1]):
            raise ValueError("output data shape mismatch")

        if isinstance(RM, (tuple, list)):
            RM_in, RM_out = RM
        else:
            RM_in = RM_out = RM

        action, parts, pack, unravel = nnet_action_factory(
            structure, self.g, self.g_out, self.U, self.Y, RM_in, RM_out,
            clamp_input=clamp_input, dtype=dtype, device=device)
        self._unravel = unravel
        self._clamp_input = clamp_input

        rng = np.random.default_rng(seed)
        W = ([np.asarray(w) for w in W0] if W0 is not None else
             [init_scale * rng.normal(size=(structure[i + 1], structure[i]))
              for i in range(L - 1)])
        b = ([np.asarray(x) for x in b0] if b0 is not None else
             [np.zeros(structure[i + 1]) for i in range(L - 1)])
        if X0 is None:
            X = [self.U.copy()]
            for l in range(L - 1):
                act = self.g_out if l == L - 2 else self.g
                z = torch.as_tensor(X[l] @ W[l].T + b[l]).to(tdtype)
                X.append(act(z).numpy())
        else:
            X = [np.asarray(x) for x in X0]
        if clamp_input:
            X = X[1:]
        XP0 = pack({"X": X, "W": W, "b": b})

        rf0 = np.asarray(RF0, dtype)
        if rf0.ndim not in (0, 1) or (rf0.ndim == 1
                                      and rf0.shape != (L - 1,)):
            raise ValueError("RF0 must be scalar or per-layer (L-1,)")
        opts = make_lbfgs_options(opt_args, dtype)
        betas = np.asarray(beta_array, dtype=dtype)

        lower = upper = None
        if bounds_W is not None:
            # box bounds on the weights only; biases and activations free
            wlo, whi = bounds_W

            def box(w_val, inf):
                return pack({"X": [np.full(x.shape, inf) for x in X],
                             "W": [np.full(w.shape, w_val) for w in W],
                             "b": [np.full(x.shape, inf) for x in b]})
            lower, upper = box(wlo, -np.inf), box(whi, np.inf)

        xp0 = torch.as_tensor(XP0, device=device)
        kw = dict(lower=lower, upper=upper, opts=opts,
                  store_paths=track_paths, device=device)
        if checkpoint_path is not None:
            res = run_ladder_checkpointed(
                action, parts, xp0, betas, rf0, float(alpha),
                ckpt_path=checkpoint_path, save_every=checkpoint_every,
                resume=resume, **kw)
        else:
            res = run_ladder(action, parts, xp0, betas, rf0, float(alpha),
                             **kw)
        res = type(res)(*(None if v is None else v.detach().cpu().numpy()
                          for v in res))

        self.beta_array = np.asarray(beta_array)
        self.A_array = res.A
        self.me_array = res.ME
        self.fe_array = res.FE
        self.exitflags = _STATUS_TO_SCIPY[res.status]
        self.niter_array = res.niter
        self.nfev_array = res.nfev
        self.XP_final = res.XP
        self.minpaths = res.paths if track_paths else res.XP[None, :]
        self.annealing_run = True
        return res

    # -- result access -------------------------------------------------
    def _tree_at(self, i):
        return self._unravel(np.asarray(self.minpaths[i]))

    def weights_at(self, i=-1):
        t = self._tree_at(i)
        return ([np.asarray(w) for w in t["W"]],
                [np.asarray(x) for x in t["b"]])

    def activations_at(self, i=-1):
        t = self._tree_at(i)
        X = [np.asarray(x) for x in t["X"]]
        if self._clamp_input:
            X = [self.U] + X
        return X

    def predict(self, U, i=-1):
        """Forward-propagate fresh inputs through the β-step-i weights, on
        this Annealer's device; a NumPy array."""
        W, b = self.weights_at(i)
        return forward(self.structure, self.g, self.g_out, W, b,
                       np.asarray(U), device=self.device).cpu().numpy()

    def save_weights(self, filename, i=-1):
        W, b = self.weights_at(i)
        flat = np.concatenate([np.ravel(w) for w in W]
                              + [np.ravel(x) for x in b])
        vio._write(filename, flat[None, :])
        return flat

    def save_action_errors(self, filename):
        if not self.annealing_run:
            raise RuntimeError("run anneal() first")
        return vio.save_action_errors(
            filename, self.beta_array, self.A_array, self.me_array,
            self.fe_array)
