"""Ahead-of-time kernel library generation (the ``libgen`` analog).

PyTorch port of ``pyjac_tpu/libgen.py``.  The reference compiles its
generated C/CUDA into ``lib*_pyjac`` archives (reference:
pyjac/libgen/libgen.py:322-411); the JAX package exports its jitted
mechanism-specialised kernels as StableHLO with ``jax.export``.  The port
exports them with ``torch.export`` as ``.pt2`` programs, each with a
*symbolic batch dimension* (``torch.export.Dim('b', min=1)``), so one
artifact serves any state count, plus a JSON manifest.

The plain kernels (``dydt``, ``jacobian``, ``jacobian_and_dydt``,
``rates``) are traced through their PyTorch functions, with float64
example inputs or, under ``dtype='f32'``, float32 ones: as the JAX
package's f32 artifacts, such a program takes float32 ``(param, y)``,
computes in float64 (it casts its inputs up, as the JAX package's f64
tables promote them) and returns float64.  The kernel entries trace the
modules' batch-minor ``call_tr``, whose float64 interface does not change
with ``dtype`` (the JAX package's dd entries keep their float32-pair one):

* ``jacobian_dd_sparse`` — ``SparseJacobian(fuse_gather=True)``, on the
  card the stage-A and stage-B kernels K1 + K2;
* ``jacobian_dd`` — ``DenseJacobian``, on the card the fused kernel K4.

On the card their programs call the registered operators
``pyjac_tpu_torch::stage_a``, ``::stage_b`` and ``::dense_fused``
(:mod:`pyjac_tpu_torch.ops.kernels`), the launches the live modules
make; exported for the CPU, they hold the kernels' plain versions.  An
artifact runs on the device it was exported for, which the manifest
records.  :func:`load_library` needs no mechanism file, parser or
packing: it imports only the module that registers the operators.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable

import torch

from .ops.common import F64, entry_device

_KERNELS = ('dydt', 'jacobian', 'jacobian_and_dydt', 'rates')

# the plain kernels' input type of each manifest dtype
_DTYPES = {'f64': F64, 'f32': torch.float32}

# the batch-minor layouts of the kernel entries (the manifest's keys)
_LAYOUTS = {
    'jacobian_dd_sparse': (
        'dd_sparse_layout',
        'batch-minor float64: (y_t[N,B], P_t[1,B]) -> (J_cols[N-1,N,B], '
        'col0[N,B], f[N,B]); J[:,0] = col0, J[:,j+1] = J_cols[j]'),
    'jacobian_dd': (
        'dd_layout',
        'batch-minor float64: (y_t[N,B], P_t[1,B]) -> (Jt[N,N,B], f[N,B]); '
        'Jt[j,i,b] = d f_i / d y_j'),
}


class _Kernel(torch.nn.Module):
    """``fn(param, y)`` as a module, for ``torch.export``, on float64
    inputs (a float32 export's are cast up first)."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, param, y):
        return self.fn(param.to(F64), y.to(F64))


class _Entry(torch.nn.Module):
    """The batch-minor ``call_tr`` of a Jacobian module, whose tables
    are then the program's buffers."""

    def __init__(self, mod):
        super().__init__()
        # each table its own storage: on the CPU some buffers are views of
        # one numpy array, which torch.export.save cannot store
        for k, t in mod._buffers.items():
            mod._buffers[k] = t.clone()
        self.mod = mod

    def forward(self, y_t, P_t):
        return self.mod.call_tr(y_t, P_t)


def _kernel_fn(packed, name: str, conp: bool):
    from .ops import rates as rates_mod
    from .ops import thermo as thermo_mod
    from .ops.dydt import dydt as dydt_fn
    from .ops.jacobian import eval_jacobian, jacobian_and_dydt

    if name == 'dydt':
        return lambda p, y: dydt_fn(packed, 0.0, p, y, conp=conp)
    if name == 'jacobian':
        return lambda p, y: eval_jacobian(packed, 0.0, p, y, conp=conp)
    if name == 'jacobian_and_dydt':
        return lambda p, y: jacobian_and_dydt(packed, 0.0, p, y, conp=conp)
    if name == 'rates':
        def fn(p, y):
            T = y[..., 0]
            if conp:
                # p is pressure [Pa]
                _, _, _, conc = thermo_mod.eval_conc(packed, T, p,
                                                     y[..., 1:])
                pres = p
            else:
                # p is density [kg/m^3]; recover pressure from the state
                _, _, pres, conc = thermo_mod.eval_conc_rho(packed, T, p,
                                                            y[..., 1:])
            fwd, rev = rates_mod.eval_rxn_rates(packed, T, pres, conc)
            pm = rates_mod.get_rxn_pres_mod(packed, T, pres, conc)
            return fwd, rev, pm
        return fn
    raise ValueError('unknown kernel ' + name)


def _example(N: int, B: int, conp: bool, device, dtype=F64):
    """(param (B,), y (B, N)) in ``dtype``: a plausible state for
    tracing (1000 K, equal mass fractions, 1 atm, or under CONV
    1 kg/m^3)."""
    y = torch.full((B, N), 1.0 / N, dtype=dtype, device=device)
    y[:, 0] = 1000.0
    param = torch.full((B,), 101325.0 if conp else 1.0, dtype=dtype,
                       device=device)
    return param, y


def _dtype(dtype: str):
    if dtype not in _DTYPES:
        raise ValueError("dtype must be 'f64' or 'f32', got %r" % (dtype,))
    return _DTYPES[dtype]


def export_kernel(packed, name: str, conp: bool = True, device='cuda',
                  dtype: str = 'f64'):
    """The ``torch.export.ExportedProgram`` of one kernel for ``device``
    (the CUDA card unless the caller asks for another), its batch a
    symbolic ``Dim('b', min=1)``: a plain kernel of ``(param, y)``
    (float64 inputs, or float32 under ``dtype='f32'``; float64 outputs)
    or a kernel entry of float64 ``(y_t, P_t)``.  opt_einsum's path
    search guards on the batch size, so the trace contracts the
    three-operand einsums (Chebyshev rates) in their written order."""
    from .ops.jacobian_dense import DenseJacobian
    from .ops.jacobian_sparse import SparseJacobian

    device = entry_device(device)
    b = torch.export.Dim('b', min=1)
    entry = name in _LAYOUTS
    param, y = _example(packed.n_species, 5, conp, device,
                        F64 if entry else _dtype(dtype))
    if name == 'jacobian_dd':
        mod = _Entry(DenseJacobian(packed, conp=conp, device=device))
    elif name == 'jacobian_dd_sparse':
        mod = _Entry(SparseJacobian(packed, conp=conp, fuse_gather=True,
                                    device=device))
    else:
        mod = _Kernel(_kernel_fn(packed, name, conp))
    if isinstance(mod, _Entry):
        args, dyn = (y.T.contiguous(), param[None].contiguous()), ({1: b},
                                                                    {1: b})
    else:
        args, dyn = (param, y), ({0: b}, {0: b})
    with torch.backends.opt_einsum.flags(enabled=False):
        return torch.export.export(mod, args, dynamic_shapes=dyn)


def generate_library(packed, out_dir: str,
                     kernels: Iterable[str] = _KERNELS,
                     conp: bool = True, device='cuda',
                     dtype: str = 'f64') -> str:
    """Export the given kernels (:func:`export_kernel`) into ``out_dir``
    for ``device`` (the CUDA card unless the caller asks for another);
    returns the manifest's path.  ``dtype`` ('f64' or 'f32', recorded in
    the manifest) is the plain kernels' input type; every artifact
    computes in and returns float64."""
    _dtype(dtype)
    device = entry_device(device)
    os.makedirs(out_dir, exist_ok=True)
    entries, layouts = {}, {}
    for name in kernels:
        prog = export_kernel(packed, name, conp, device, dtype)
        fname = '{}_{}.pt2'.format(name, 'conp' if conp else 'conv')
        torch.export.save(prog, os.path.join(out_dir, fname))
        entries[name] = fname
        if name in _LAYOUTS:
            key, text = _LAYOUTS[name]
            layouts[key] = text

    manifest = {
        'format': 'torch.export/pt2',
        'n_species': packed.n_species,
        'n_reactions': packed.n_reactions,
        'species': list(packed.species_names),
        'conp': bool(conp),
        'dtype': dtype,
        'device': str(device),
        'state_layout': '[T, Y_1..Y_{N-1}]',
        'param': 'pressure [Pa]' if conp else 'density [kg/m^3]',
        'kernels': entries,
        **layouts,
    }
    man_path = os.path.join(out_dir, 'library.json')
    with open(man_path, 'w') as fh:
        json.dump(manifest, fh, indent=2)
    return man_path


def load_library(out_dir: str) -> Dict[str, object]:
    """Load exported kernels; returns {'manifest': ..., '<kernel>': fn}.

    The plain kernels take ``(param, y)`` like the live functions (in
    the manifest's ``dtype``), the kernel entries ``(y_t, P_t)`` like
    ``call_tr``; each returns float64 and runs the
    exported program on the device it was exported for (tensors must
    lie there).  No mechanism file, parser or packing is involved."""
    from .ops import kernels  # noqa: F401  (registers the operators)

    with open(os.path.join(out_dir, 'library.json')) as fh:
        manifest = json.load(fh)
    out = {'manifest': manifest}
    for name, fname in manifest['kernels'].items():
        out[name] = torch.export.load(os.path.join(out_dir, fname)).module()
    return out
