"""const_hoisted_jit: jit without embedded array constants.

A jitted function whose HLO embeds array constants (anything a traced
function closes over — target parameters, beta grids, frozen params) carries
them inside the executable, which lengthens compilation and can add a fixed
cost to every execution. This wrapper traces the function once, extracts the
jaxpr constants, keeps them device-resident, and feeds them back as ordinary
arguments on every call. Whether it still pays on the GPU is an open
question until the benchmark measures it.

Use for hot eval/sampling entry points whose targets close over constants
(every target in the zoo does).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import tree_util


def const_hoisted_jit(fn, *example_args):
    """Returns jitted fn(*args) with all captured constants passed as args.

    example_args: abstract (jax.ShapeDtypeStruct) or concrete examples with
    the call-time structure. The returned callable must be invoked with
    arguments of that same pytree structure/shapes.
    """
    flat_ex, in_tree = tree_util.tree_flatten(example_args)
    out_tree_box = []

    def flat_fn(*flat_args):
        args = tree_util.tree_unflatten(in_tree, list(flat_args))
        out = fn(*args)
        flat_out, out_tree = tree_util.tree_flatten(out)
        if not out_tree_box:
            out_tree_box.append(out_tree)
        return flat_out

    closed = jax.make_jaxpr(flat_fn)(*flat_ex)
    out_tree = out_tree_box[0]
    consts = [jax.device_put(jnp.asarray(c)) for c in closed.consts]

    @jax.jit
    def run(consts, flat_args):
        return jax.core.eval_jaxpr(closed.jaxpr, consts, *flat_args)

    def wrapper(*args):
        flat_args, tree = tree_util.tree_flatten(args)
        if tree != in_tree:
            raise TypeError(
                f"const_hoisted_jit: argument structure {tree} does not match "
                f"the example structure {in_tree}"
            )
        return tree_util.tree_unflatten(out_tree, run(consts, flat_args))

    return wrapper
