"""Result writers and the data loader of the facade.

A copy of ``varanneal_tpu/io.py`` (the port imports nothing of the JAX
package): the same functions and the same file formats, byte-compatible
with the reference's output layouts (``varanneal/va_ode.py ::
Annealer.save_paths / save_params / save_action_errors`` [M, SURVEY.md
§3.5]; exact layouts are pinned decisions — see each function).

Format dispatch on filename extension: ``.npy`` -> ``np.save``; anything
else -> ``np.savetxt`` (the reference supports both [M]).
"""

import numpy as np


def _write(path: str, arr: np.ndarray):
    arr = np.asarray(arr)
    if str(path).endswith(".npy"):
        np.save(path, arr)
    else:
        # savetxt handles <=2-D; flatten leading axes like the reference
        np.savetxt(path, arr.reshape(-1, arr.shape[-1]))


def save_paths(path, minpaths_X, t_f):
    """(Nbeta, N_f, D) state paths + (N_f,) times -> (Nbeta, N_f, D+1) with
    time prepended as column 0 [pinned: SURVEY.md checklist 'save_paths
    output layout']."""
    minpaths_X = np.asarray(minpaths_X)
    Nb, N_f, D = minpaths_X.shape
    out = np.empty((Nb, N_f, D + 1), dtype=minpaths_X.dtype)
    out[:, :, 0] = np.asarray(t_f)[None, :]
    out[:, :, 1:] = minpaths_X
    _write(path, out)
    return out


def save_params(path, minparams, t_f=None):
    """Estimated parameters per β.

    Static params: (Nbeta, NPest) saved as-is. Time-dependent params:
    (Nbeta, N_f, NPest) saved as (Nbeta, N_f, NPest+1) with time prepended
    [pinned decision]."""
    minparams = np.asarray(minparams)
    if minparams.ndim == 3:
        Nb, N_f, NPest = minparams.shape
        out = np.empty((Nb, N_f, NPest + 1), dtype=minparams.dtype)
        out[:, :, 0] = np.asarray(t_f)[None, :]
        out[:, :, 1:] = minparams
    else:
        out = minparams
    _write(path, out)
    return out


def save_action_errors(path, beta_array, A, ME, FE):
    """Per-β action decomposition: columns [β, A, ME, FE]
    [pinned: SURVEY.md checklist 'save_action_errors column order']."""
    out = np.column_stack([
        np.asarray(beta_array, dtype=np.float64),
        np.asarray(A), np.asarray(ME), np.asarray(FE)])
    _write(path, out)
    return out


def load_data(path):
    """Load a data file: ``.npy`` via np.load, else np.loadtxt. Column 0 is
    time (reference ``set_data_fromfile`` convention [M])."""
    path = str(path)
    if path.endswith(".npy"):
        return np.load(path)
    return np.loadtxt(path)
