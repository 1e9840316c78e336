"""Chain drivers: the JAX replacement for KSPRICHARDSON chains.

In the reference, a sampling chain is ``KSPSolve`` with KSPRICHARDSON,
norms disabled and ``max_it = n_samples``, observing the stream through a
composed sample callback (``examples/ex1.c:90-129``,
``src/parmgmc.c:139-151``).  Here a chain is one ``lax.scan`` over the
sampler's ``step`` — a single compiled program per (sampler, n_samples)
— and "callbacks" are pure reducers/extractors folded into the scan
carry, so nothing leaves the device until the chain finishes.

Multiple independent chains (serialized in the reference, ex6/ex7) are a
``vmap`` over a key axis — chain parallelism for free.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = [
    "ChainState",
    "init_chain",
    "sample_chain",
    "sample_moments",
    "multi_chain",
]


class ChainState(NamedTuple):
    x: jax.Array
    key: jax.Array


def init_chain(
    sampler,
    key: jax.Array,
    x0: Optional[jax.Array] = None,
    batch: tuple = (),
) -> ChainState:
    """Fresh chain state.  ``batch`` appends trailing chain dims for the
    chain-major multichain layout (x of shape grid_shape + (C,)): C
    independent chains advanced by ONE keyed step each iteration —
    the preferred layout for unstructured (GraphOperator) samplers,
    whose gathers amortize the index stream over the chain axis."""
    if x0 is None:
        x0 = jnp.zeros(
            tuple(sampler.grid_shape) + tuple(batch), dtype=sampler.dtype
        )
    return ChainState(x=x0, key=key)


def sample_chain(
    sampler,
    state: ChainState,
    b: jax.Array,
    n_samples: int,
    extract: Optional[Callable[[jax.Array], Any]] = None,
    burnin: int = 0,
):
    """Run the chain, returning (state, stacked extracts of each sample).

    ``extract`` maps a sample field to whatever should be recorded (a QOI
    scalar, the full field, ...).  Default records full samples — mind the
    memory for large grids.
    """
    aux = sampler.prepare(b)
    extract = extract or (lambda x: x)

    if burnin == 0:

        def record_fn(st, _):
            key, x = sampler.step(st.key, st.x, b, aux)
            return ChainState(x=x, key=key), extract(x)

        state, out = jax.lax.scan(record_fn, state, None, length=n_samples)
        return state, out

    # Single scan over burnin + n_samples (two scans would compile two
    # distinct XLA programs): recorded extracts land in a carried buffer
    # at index clip(i - burnin); burn-in steps harmlessly overwrite
    # slot 0, which the first recorded step then claims.
    probe = jax.eval_shape(lambda s: extract(s.x), state)
    out0 = jax.tree_util.tree_map(
        lambda p: jnp.zeros((n_samples, *p.shape), p.dtype), probe
    )

    def step_fn(carry, i):
        st, out = carry
        key, x = sampler.step(st.key, st.x, b, aux)
        j = jnp.clip(i - burnin, 0, n_samples - 1)
        out = jax.tree_util.tree_map(
            lambda buf, v: jax.lax.dynamic_update_index_in_dim(buf, v, j, 0),
            out,
            extract(x),
        )
        return (ChainState(x=x, key=key), out), None

    (state, out), _ = jax.lax.scan(
        step_fn, (state, out0), jnp.arange(burnin + n_samples)
    )
    return state, out


def sample_moments(
    sampler,
    state: ChainState,
    b: jax.Array,
    n_samples: int,
    burnin: int = 0,
):
    """Run the chain accumulating running mean and variance (Welford).

    Replaces the reference's running-mean sample callbacks
    (``examples/ex1.c:57-64``) and MSBeginSaveSamples/MSGetMeanAndVar
    (``src/ms.c:221-265``) without storing the sample stream.
    """
    aux = sampler.prepare(b)
    mean0 = jnp.zeros_like(state.x)
    m2_0 = jnp.zeros_like(state.x)

    # One scan over burnin + n_samples (not two compiled programs); the
    # Welford update is masked out during burn-in.  The step index stays
    # integer — a float32 index drifts past 2^24 samples — and is cast
    # only inside the division.
    def step_fn(carry, i):
        st, mean, m2 = carry
        key, x = sampler.step(st.key, st.x, b, aux)
        recording = i >= burnin
        cnt = (i - burnin + 1).astype(x.dtype)
        delta = x - mean
        mean_new = mean + delta / cnt
        m2_new = m2 + delta * (x - mean_new)
        mean = jnp.where(recording, mean_new, mean)
        m2 = jnp.where(recording, m2_new, m2)
        return (ChainState(x=x, key=key), mean, m2), None

    (state, mean, m2), _ = jax.lax.scan(
        step_fn, (state, mean0, m2_0), jnp.arange(burnin + n_samples)
    )
    var = m2 / jnp.maximum(n_samples - 1, 1)
    return state, mean, var


def multi_chain(fn: Callable, n_chains: int):
    """vmap a chain function over a leading axis of keys/states.

    The reference runs multiple chains serially (``examples/ex6.c:
    184-188``, ``ex7.c:198-216``); here the chain axis vectorizes.
    """
    return jax.vmap(fn)
