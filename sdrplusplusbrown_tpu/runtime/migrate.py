"""Carried-state migration across pipeline reconfiguration.

The reference preserves DSP state through live reconfiguration: FIR
history survives tap-count changes (zero-extend / truncate,
ref: core/src/dsp/filter/fir.h:33-54) and the whole graph edit happens
under tempStop/tempStart without flushing loop state
(ref: decoder_modules/radio/src/radio_module.h:655-774) so a bandwidth
change or demod switch is click-free.  This build's state is an
explicit pytree, so migration is a structural tree merge:

* identical path + shape → carry the old leaf (cast to the new dtype);
* same rank, same leading dims, different LAST axis → align RIGHT
  (state vectors are overlap-save histories ordered oldest→newest:
  keep the newest samples, zero-fill the unknown older past — exactly
  the reference's FIR resize rule);
* anything else (new key, rank change, dtype-kind change, leading-dim
  change) → the fresh template leaf.

``migrate_state(old, template)`` never fails: worst case it returns the
template (a cold init), best case the whole state carries over.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _leaf_migrate(old, new):
    if old is None:
        return new
    if not hasattr(new, "shape"):
        # python scalar / aux value: carry when same type
        return old if type(old) is type(new) else new
    if not hasattr(old, "shape"):
        return new
    old = jnp.asarray(old)
    new_dt = np.dtype(new.dtype)
    old_dt = np.dtype(old.dtype)
    if old_dt.kind != new_dt.kind and not (
            old_dt.kind in "fc" and new_dt.kind in "fc"):
        return new
    if old_dt.kind == "c" and new_dt.kind == "f":
        return new                       # complex → real: incompatible
    if old.ndim != jnp.ndim(new):
        return new
    if tuple(old.shape) == tuple(new.shape):
        return old.astype(new.dtype)
    if old.ndim == 0 or tuple(old.shape[:-1]) != tuple(new.shape[:-1]):
        return new
    n_old = old.shape[-1]
    n_new = new.shape[-1]
    if n_old >= n_new:                   # truncate: keep newest samples
        return old[..., n_old - n_new:].astype(new.dtype)
    pad = [(0, 0)] * (old.ndim - 1) + [(n_new - n_old, 0)]
    return jnp.pad(old.astype(new.dtype), pad)


def migrate_state(old_state, template):
    """Merge ``old_state`` into the shape of ``template`` (a fresh
    ``init_state`` pytree of the NEW pipeline) using the resize rules
    above.  Leaves of ``template`` with no matching path in
    ``old_state`` stay fresh."""
    if old_state is None:
        return template
    old_map = {}
    try:
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                old_state)[0]:
            old_map[jax.tree_util.keystr(path)] = leaf
    except Exception:
        return template
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for path, new_leaf in flat:
        key = jax.tree_util.keystr(path)
        out.append(_leaf_migrate(old_map.get(key), new_leaf))
    return jax.tree_util.tree_unflatten(treedef, out)
