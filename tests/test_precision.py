"""Every f32 contraction of the sampling path asks for HIGHEST precision.

On tensor-core GPUs a float32 matmul runs in TF32 (a 10-bit mantissa)
unless asked not to.  That is wrong by ~1e-3 in the exact coarse draw
and the rank-k Woodbury terms, and an inexact coarse draw wrecks MGMC
mixing (docs/samplers.md).  The CPU cannot show the difference in
numbers, so these tests read the precision each contraction requests:
from the jaxpr where the site traces, and by recording the call where
it runs eagerly at set-up.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parmgmc_tpu.operators.lrc import LRCOperator
from parmgmc_tpu.operators.stencil import shifted_laplace_fd
from parmgmc_tpu.samplers.cholesky import CholeskySampler
from parmgmc_tpu.samplers.gibbs import GibbsSampler, _draw, build_lrc_correction
from parmgmc_tpu.samplers.woodbury import WoodburySampler

HIGHEST = jax.lax.Precision.HIGHEST
F32 = jnp.float32
GRID = (6, 6)


def _dot_precisions(jaxpr):
    """precision params of every dot_general, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn.params["precision"]
        for v in eqn.params.values():
            for j in v if isinstance(v, (tuple, list)) else (v,):
                inner = getattr(j, "jaxpr", j)
                if hasattr(inner, "eqns"):
                    yield from _dot_precisions(inner)


def _all_highest(precs):
    precs = list(precs)
    assert precs, "no contraction traced"
    for p in precs:
        pair = p if isinstance(p, tuple) else (p, p)
        if not all(q == HIGHEST for q in pair):
            return False
    return True


def _lrc(k=2):
    base = shifted_laplace_fd(GRID, 2.0, dtype=F32)
    B = jax.random.normal(jax.random.PRNGKey(0), (*GRID, k), F32)
    return LRCOperator(base=base, B=B, sigma_inv=jnp.ones((k,), F32))


def _x():
    return jax.random.normal(jax.random.PRNGKey(1), GRID, F32)


def _site(name):
    op = _lrc()
    x = _x()
    if name == "lrc.bt_apply":
        return jax.make_jaxpr(lambda o, v: o.bt_apply(v))(op, x)
    if name == "lrc.b_apply":
        return jax.make_jaxpr(lambda o, w: o.b_apply(w))(op, jnp.ones((2,), F32))
    if name == "lrc.to_dense":
        return jax.make_jaxpr(lambda o: o.to_dense())(op)
    if name == "gibbs.half_step":
        smp = GibbsSampler.create(op, sweep="symmetric")
        n = _draw(jax.random.PRNGKey(2), smp.noise_shapes(), F32)
        return jax.make_jaxpr(lambda s, v, nn: s.step_with_noise(v, None, nn))(
            smp, x, n
        )
    if name == "gibbs.build_lrc_correction":
        return jax.make_jaxpr(
            lambda b, B, s: build_lrc_correction(b, B, s, 1.0, "forward")
        )(op.base, op.B, op.sigma_inv)
    if name in ("cholesky.prepare", "cholesky.step_with_noise"):
        smp = CholeskySampler.create(op.base)
        assert smp.Li is not None
        if name == "cholesky.prepare":
            return jax.make_jaxpr(lambda s, b: s.prepare(b))(smp, x)
        eta = jnp.ones((smp.n,), F32)
        return jax.make_jaxpr(
            lambda s, b, e: s.step_with_noise(None, b, [{"eta": e}])
        )(smp, x, eta)
    if name == "woodbury.step_with_noise":
        smp = WoodburySampler.create(op, CholeskySampler.create(op.base))
        n = _draw(jax.random.PRNGKey(3), smp.noise_shapes(), F32)
        return jax.make_jaxpr(lambda s, v, nn: s.step_with_noise(v, None, nn))(
            smp, x, n
        )
    raise ValueError(name)


@pytest.mark.parametrize(
    "name",
    [
        "lrc.bt_apply",
        "lrc.b_apply",
        "lrc.to_dense",
        "gibbs.half_step",
        "gibbs.build_lrc_correction",
        "cholesky.prepare",
        "cholesky.step_with_noise",
        "woodbury.step_with_noise",
    ],
)
def test_traced_contractions_request_highest(name):
    assert _all_highest(_dot_precisions(_site(name).jaxpr))


def test_probe_sees_default_precision():
    """The jaxpr probe is not vacuous: a plain product fails it."""
    jp = jax.make_jaxpr(lambda a: a @ a)(jnp.ones((3, 3), F32))
    assert not _all_highest(_dot_precisions(jp.jaxpr))


def test_graph_sharded_lrc_step_requests_highest():
    from jax.sharding import Mesh

    from parmgmc_tpu.models.mesh import matern_precision_mesh, unit_square_mesh
    from parmgmc_tpu.operators.graph import from_csr
    from parmgmc_tpu.parallel.graph_sharded import make_sharded_graph_mgmc_step
    from parmgmc_tpu.samplers.mgmc import MGMCSampler

    pts, cells = unit_square_mesh(6)
    g = from_csr(matern_precision_mesh(pts, cells, 3.0), dtype=F32)
    B = np.zeros((g.n, 2), np.float32)
    B[:5, 0] = 1.0
    B[-5:, 1] = 1.0
    op = LRCOperator(base=g, B=jnp.asarray(B), sigma_inv=jnp.ones((2,), F32))
    smp = MGMCSampler.create(op, coarsest_size=8)
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    step, spec, shard = make_sharded_graph_mgmc_step(smp, mesh, coords=pts)
    from parmgmc_tpu.parallel.graph_sharded import to_local

    xl = jax.device_put(to_local(spec, jnp.zeros((g.n,), F32)), shard)
    jp = jax.make_jaxpr(step)(jax.random.PRNGKey(0), xl, xl)
    assert _all_highest(_dot_precisions(jp.jaxpr))


class _Recorder:
    """Wraps jnp.tensordot / jnp.matmul to record each call's precision."""

    def __init__(self, monkeypatch):
        self.calls = []
        for fname in ("tensordot", "matmul"):
            orig = getattr(jnp, fname)

            def wrapped(*a, _orig=orig, **kw):
                self.calls.append(kw.get("precision"))
                return _orig(*a, **kw)

            monkeypatch.setattr(jnp, fname, wrapped)


@pytest.mark.parametrize(
    "name", ["obs.make_observation_mats", "woodbury.create", "cholesky.create"]
)
def test_eager_setup_contractions_request_highest(name, monkeypatch):
    op = _lrc()
    rec = _Recorder(monkeypatch)
    if name == "obs.make_observation_mats":
        from parmgmc_tpu.models.obs import make_observation_mats

        make_observation_mats(
            GRID, 0.1, np.array([[0.5, 0.5]]), np.array([0.3]),
            obsvals=np.ones(1), dtype=F32,
        )
    elif name == "woodbury.create":
        WoodburySampler.create(op, CholeskySampler.create(op.base))
    else:
        CholeskySampler.create(op.base)
    assert rec.calls, "no contraction recorded"
    assert all(p == HIGHEST for p in rec.calls), rec.calls
