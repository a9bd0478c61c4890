"""The JAX references of the port's CPU tests, each as one compiled
program.

Called op by op, a flax `init` or `apply` (and its gradient) compiles
every primitive at every shape it meets; on an empty compilation cache
that is most of a reference's seconds.  One `jax.jit` of the whole call
compiles once and computes the same function (a fused program may round
differently, within 1e-6 of the values, far inside every tolerance the
tests hold the port to).  Keyword arguments (a `method`, flags) are bound
to the function, not traced.
"""

import functools

import jax


def init(module, *args, **kwargs):
    """`module.init(*args, **kwargs)`, compiled."""
    return jax.jit(functools.partial(module.init, **kwargs))(*args)


def apply(module, params, *args, **kwargs):
    """`module.apply(params, *args, **kwargs)`, compiled."""
    return jax.jit(functools.partial(module.apply, **kwargs))(params, *args)
