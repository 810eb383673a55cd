"""Shared harness of the port's flow-estimator parity tests.

A port estimator is built with seeded weights (``flow.api.init_model``);
its state dict, laid out as a flax tree (:func:`jax_tree`), is the JAX
module's variables (flax's ``apply`` refuses a tree that lacks a leaf or
holds one of another shape), and crosses back through
``flow.convert.flow_state_from_jax`` into a second port model, so the
JAX side runs the same weights without tracing or compiling its
``init``. The JAX forward runs under ``jax.jit`` (``FAST_COMPILE``), the
training-mode levels and the ``inference=True`` flow in one compiled
call.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from followyourclick_tpu_torch.flow.api import init_model
from followyourclick_tpu_torch.flow.convert import flow_state_from_jax
from followyourclick_tpu_torch.flow.registry import flow_estimator

# relative L2 between two fp32 runs of the same estimator
REL_L2 = 1e-4
SIZE = 64
# XLA:CPU without its backend optimisations: the estimators' compiles take
# ~40 % less time (IRR-PWC 28.0 → 16.9 s here), the 64² runs stay short
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def images(seed: int, batch: int = 2, size: int = SIZE):
    """A seeded pair of normalised images, NHWC: the second a shifted copy
    of the first plus noise, so that the flow has something to find."""
    rs = np.random.RandomState(seed)
    big = rs.rand(batch, size + 8, size + 8, 3).astype(np.float32)
    img1 = big[:, 4:4 + size, 4:4 + size]
    img2 = big[:, 2:2 + size, 5:5 + size] + 0.05 * rs.randn(
        batch, size, size, 3).astype(np.float32)
    return 2 * img1 - 1, 2 * img2 - 1


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a), -1, 1)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


def jax_tree(model: torch.nn.Module) -> dict:
    """The port's state dict as a flax ``params`` tree (conv kernels
    ``(out, in, kh, kw)`` → ``(kh, kw, in, out)``)."""
    params: dict = {}
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        node = params
        for key in path:
            node = node.setdefault(key, {})
        a = t.detach().numpy()
        node[{"weight": "kernel"}.get(leaf, leaf)] = (
            a.transpose(2, 3, 1, 0) if a.ndim == 4 else a).copy()
    return {"params": params}


class Pair:
    """One estimator on both sides: ``port`` (seeded, eval mode), the JAX
    module and its variables, and the port model rebuilt from them."""

    def __init__(self, jax_module, model_cfg: dict, seed: int = 0):
        self.spec = flow_estimator(model_cfg)
        self.port = init_model(self.spec, seed=seed, device="cpu")
        self.jax_module = jax_module
        self.variables = jax_tree(self.port)
        rebuilt = init_model(self.spec, checkpoint=flow_state_from_jax(
            self.variables, self.port), device="cpu")
        for name, t in self.port.state_dict().items():
            assert torch.equal(rebuilt.state_dict()[name], t), name
        self.rebuilt = rebuilt

    def jax_run(self, img1, img2, capture=(), **kwargs):
        """(training-mode output, inference flow) of the JAX module, jitted
        together; with ``capture`` (submodule names) the training-mode
        output is ``(output, {name: that submodule's output})``."""
        m = self.jax_module

        def train(v, a, b):
            if not capture:
                return m.apply(v, a, b, **kwargs)
            out, state = m.apply(
                v, a, b, capture_intermediates=lambda mdl, _: mdl.name in
                capture, mutable=["intermediates"], **kwargs)
            got = state["intermediates"]
            return out, {k: got[k]["__call__"][0] for k in capture}

        fn = jax.jit(lambda v, a, b: (
            train(v, a, b), m.apply(v, a, b, inference=True, **kwargs)),
            compiler_options=FAST_COMPILE)
        out = fn(self.variables, img1, img2)
        return jax.tree_util.tree_map(np.asarray, out)

    @torch.no_grad()
    def port_run(self, img1, img2, model=None, **kwargs):
        model = model or self.rebuilt
        a, b = nchw(img1), nchw(img2)
        return model(a, b, **kwargs), model(a, b, inference=True, **kwargs)
