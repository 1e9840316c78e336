"""Sampler composition by config tree.

The reference composes samplers through PETSc's options database with
hierarchical string prefixes (e.g. ``-gamgmc_mg_levels_pc_type mcgibbs``;
``src/pc_gamgmc.c:43-58``, ``examples/ex9.py:48-66``).  The JAX
equivalent is an explicit nested dict: every node names a sampler type
plus its options, and inner samplers are sub-dicts.  Example::

    build_sampler(op, {
        "type": "mgmc",
        "n_levels": 3,
        "smoother": {"type": "gibbs", "omega": 1.0, "sweep": "symmetric"},
        "n_pre": 2, "n_post": 2,
        "coarse": {"type": "cholesky"},
    })

Types registered: gibbs (mcgibbs/sorgibbs analogue), cholesky
(cholsampler), mgmc (gamgmc), woodbury, patch_gibbs (the ASM
star-patch + cholsampler smoother of ex9).
"""

from __future__ import annotations

from typing import Callable, Dict

from parmgmc_tpu.operators.lrc import LRCOperator
from parmgmc_tpu.samplers.cholesky import CholeskySampler
from parmgmc_tpu.samplers.gibbs import GibbsSampler
from parmgmc_tpu.samplers.mgmc import MGMCSampler, build_hierarchy
from parmgmc_tpu.samplers.woodbury import WoodburySampler

__all__ = ["build_sampler", "register_sampler"]


_REGISTRY: Dict[str, Callable] = {}


def register_sampler(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def build_sampler(op, config: dict):
    cfg = dict(config)
    typ = cfg.pop("type")
    if typ not in _REGISTRY:
        raise ValueError(f"unknown sampler type {typ!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[typ](op, cfg)


@register_sampler("gibbs")
def _build_gibbs(op, cfg):
    omega = cfg.pop("omega", 1.0)
    sweep = cfg.pop("sweep", "forward")
    if cfg.pop("ordering", "multicolor") == "natural":
        from parmgmc_tpu.samplers.sor import NaturalGibbsSampler

        return NaturalGibbsSampler.create(op, omega=omega, sweep=sweep)
    return GibbsSampler.create(op, omega=omega, sweep=sweep)


@register_sampler("cholesky")
def _build_cholesky(op, cfg):
    mode = cfg.pop("mode", "dense")
    if mode == "sparse":
        from parmgmc_tpu.samplers.cholesky import SparseCholeskySampler

        return SparseCholeskySampler.create(op)
    if mode == "auto":
        from parmgmc_tpu.samplers.cholesky import exact_sampler

        return exact_sampler(op, cfg.pop("dense_threshold", 20_000))
    return CholeskySampler.create(op)


@register_sampler("patch_gibbs")
def _build_patch_gibbs(op, cfg):
    from parmgmc_tpu.operators.graph import GraphOperator
    from parmgmc_tpu.samplers.patch_gibbs import (
        GraphPatchGibbsSampler,
        PatchGibbsSampler,
    )

    if isinstance(op, GraphOperator):
        return GraphPatchGibbsSampler.create(op)
    return PatchGibbsSampler.create(op)


@register_sampler("mgmc")
def _build_mgmc(op, cfg):
    smoother_cfg = cfg.pop("smoother", {"type": "gibbs"})
    coarse_cfg = cfg.pop("coarse", {"type": "cholesky"})
    ops, transfers = build_hierarchy(
        op,
        n_levels=cfg.pop("n_levels", None),
        coarsest_size=cfg.pop("coarsest_size", 128),
        coarsening=cfg.pop("coarsening", "linear"),
    )
    smoothers = tuple(build_sampler(o, dict(smoother_cfg)) for o in ops[:-1])
    coarse = build_sampler(ops[-1], dict(coarse_cfg))
    return MGMCSampler(
        ops=tuple(ops),
        transfers=transfers,
        smoothers=smoothers,
        coarse=coarse,
        n_pre=cfg.pop("n_pre", 1),
        n_post=cfg.pop("n_post", 1),
        n_levels=len(ops),
        n_coarse=cfg.pop("n_coarse", 1),
        gamma=cfg.pop("gamma", 1),
    )


@register_sampler("woodbury")
def _build_woodbury(op, cfg):
    assert isinstance(op, LRCOperator), "woodbury requires an LRCOperator"
    inner_cfg = cfg.pop("sampler", {"type": "cholesky"})
    inner = build_sampler(op.base, dict(inner_cfg))
    return WoodburySampler.create(op, inner, solver=cfg.pop("solver", "auto"))
