"""Carry state across from numpy: params, population, task state, batches.

Converters from numpy copies of the JAX package's objects (or any arrays
of the same layout) into the port's tensors, and back.  They are what
lets a test start both packages from the same model, fleet, data and
per-round draws, and the §V ``run`` from the same params and packet
uniforms.  Integer arrays (labels) become int64; float arrays take
``dtype``.  Like the entry points, ``device=None`` means the card
(``"cuda"``); pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.federated.system import RunStart
from repro_torch.fleet.engine import RoundDraws, SimStart
from repro_torch.fleet.topology import (POPULATION_ARRAYS, ClientPopulation,
                                        HexState)
from repro_torch.serve.export import PrunedBundle

__all__ = ["tensor", "tree_from_numpy", "population_from_numpy",
           "round_draws_from_numpy", "start_from_numpy",
           "run_start_from_numpy", "to_numpy", "bundle_from_numpy"]


def tensor(a, dtype: Optional[torch.dtype] = torch.float32, device=None
           ) -> torch.Tensor:
    """One array -> tensor; integer arrays become int64, float arrays
    ``dtype`` (``None``: their own, a bfloat16 array's included)."""
    a = np.array(a)  # a writable copy: arrays from JAX are read-only
    device = resolve_device(device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16: take its bits
        t = torch.as_tensor(a.view(np.int16), device=device).view(
            torch.bfloat16)
    else:
        t = torch.as_tensor(a, device=device)
    return t if dtype is None else t.to(dtype)


def tree_from_numpy(tree, dtype: Optional[torch.dtype] = torch.float32,
                    device=None):
    """Nested dicts and lists of arrays -> the same structure of tensors:
    params (``{"layer{i}": {"w": (in, out), "b": (out,)}}``, or a
    transformer's ``{"embed", "final_norm", "stages": [...]}``, MoE experts
    and all, with an encoder subtree and ``memory_proj``), a decode cache
    (``{"pos", "stages"}``), task state (``templates``, ``x_test``,
    ``y_test``) or cached client batches (``{"x": (n, batch, D), "y":
    (n, batch)}``).  ``dtype=None`` keeps each leaf's own: a bfloat16
    model's float32 MoE router and RG-LRU ``lam`` stay float32."""
    if isinstance(tree, Mapping):
        return {k: tree_from_numpy(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, dtype, device) for v in tree)
    return tensor(tree, dtype, device)


def _field(obj: Any, name: str):
    if isinstance(obj, Mapping):
        return obj.get(name)
    return getattr(obj, name, None)


def population_from_numpy(pop: Any, dtype: torch.dtype = torch.float32,
                          device=None) -> ClientPopulation:
    """A population with the ``ClientPopulation`` fields (a mapping or an
    object with those attributes, e.g. the reference's NamedTuple); its
    ``geometry``, where present and not None, has the ``HexState``
    fields (``nbr_idx`` becomes int64)."""
    geo = _field(pop, "geometry")
    if geo is not None:
        geo = HexState(*(tensor(_field(geo, f), dtype, device)
                         for f in HexState._fields))
    return ClientPopulation(*(tensor(_field(pop, f), dtype, device)
                              for f in POPULATION_ARRAYS), geometry=geo)


def round_draws_from_numpy(h_up, h_down, u_strag, u_arr, gumbel=None,
                           dtype: torch.dtype = torch.float32,
                           device=None, **hex_draws) -> RoundDraws:
    """One draw's gains and uniforms, the Gumbel scores a partial schedule
    ranks (``None`` for a full one) and, by keyword, a hex geometry's
    draws (``ray_up``, ``ray_down``, ``jitter``, ``ray_handover``,
    ``ray_cross``) -> ``RoundDraws``."""
    return RoundDraws(
        *(None if a is None else tensor(a, dtype, device)
          for a in (h_up, h_down, u_strag, u_arr, gumbel)),
        **{k: None if a is None else tensor(a, dtype, device)
           for k, a in hex_draws.items()})


def start_from_numpy(params: Mapping, task_state: Mapping,
                     batches: Optional[Mapping] = None,
                     dtype: torch.dtype = torch.float32,
                     device=None,
                     params_dtype: Optional[torch.dtype] = None) -> SimStart:
    """The model and data side of a run -> ``SimStart`` (``batches=None``:
    the run draws them from the task state).  ``params_dtype`` (None:
    ``dtype``) is the params' own: a transformer's stay in its config's
    parameter dtype in a float64 run, as the reference's do.  A
    transformer's token pool, eval tokens and cached token batches ride
    in the task state and batches (integers: int64)."""
    return SimStart(
        tree_from_numpy(params, params_dtype or dtype, device),
        tree_from_numpy(task_state, dtype, device),
        None if batches is None else tree_from_numpy(batches, dtype, device))


def run_start_from_numpy(params: Mapping, uniforms,
                         dtype: torch.dtype = torch.float32,
                         device=None) -> RunStart:
    """The §V ``run``'s draws -> ``RunStart``: the MLP's initial params
    (``{"layer{i}": {"w", "b"}}``) and each round's packet uniforms,
    (rounds, num_clients), both in ``dtype``."""
    return RunStart(tree_from_numpy(params, dtype, device),
                    tensor(uniforms, dtype, device))


def bundle_from_numpy(bundle: Any, dtype: torch.dtype = torch.float32,
                      device=None):
    """A pruned bundle (``params``, ``keeps``, ``grid``, ``rho`` as numpy,
    e.g. the reference's ``PrunedBundle``) -> the port's ``PrunedBundle``:
    params in ``dtype``, float32 keeps, grid entries as int pairs."""
    keeps = [None if k is None else tensor(k, torch.float32, device)
             for k in bundle.keeps]
    grid = [None if b is None else (int(b[0]), int(b[1]))
            for b in bundle.grid]
    return PrunedBundle(params=tree_from_numpy(bundle.params, dtype, device),
                        keeps=keeps, grid=grid, rho=float(bundle.rho))


def to_numpy(tree):
    """Tensors (nested in dicts and lists) -> numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()
