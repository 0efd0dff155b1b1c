"""SE3/Sim3 of the PyTorch port against splatslam_tpu.ops.lie on random
elements (float32, atol 1e-5: both evaluate the same closed forms, so
only rounding order differs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu.ops import lie as jl
from splatslam_tpu_torch.ops import lie as tl
from test_torch_threads import few_torch_threads  # noqa: F401

ATOL = 1e-5


def _rand(seed, n, dim, scale):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, dim) * scale).astype(np.float32)


def _both(fn_j, fn_t, *args):
    a = np.asarray(fn_j(*[jnp.asarray(x) for x in args]))
    b = fn_t(*[torch.as_tensor(np.array(x)) for x in args]).numpy()
    return a, b


# small tangents exercise the Taylor branches, large ones the closed forms
@pytest.mark.parametrize("scale", [1e-4, 0.5])
@pytest.mark.parametrize("op", ["exp", "log", "act", "retr", "inv",
                                "adjoint", "to_matrix"])
def test_se3_ops_match(op, scale):
    xi = _rand(0, 64, 6, scale)
    g = np.asarray(jl.exp(jnp.asarray(_rand(1, 64, 6, scale))))
    X = _rand(2, 64, 4, 1.0)
    args = {"exp": (xi,), "log": (g,), "act": (g, X), "retr": (g, xi),
            "inv": (g,), "adjoint": (g,), "to_matrix": (g,)}[op]
    a, b = _both(getattr(jl, op), getattr(tl, op), *args)
    np.testing.assert_allclose(b, a, atol=ATOL)


@pytest.mark.parametrize("scale", [1e-4, 0.5])
@pytest.mark.parametrize("op", ["sim3_exp", "sim3_log", "sim3_act",
                                "sim3_retr", "sim3_inv", "sim3_adjoint"])
def test_sim3_ops_match(op, scale):
    xi = _rand(3, 64, 7, scale)
    g = np.asarray(jl.sim3_exp(jnp.asarray(_rand(4, 64, 7, scale))))
    X = _rand(5, 64, 4, 1.0)
    args = {"sim3_exp": (xi,), "sim3_log": (g,), "sim3_act": (g, X),
            "sim3_retr": (g, xi), "sim3_inv": (g,),
            "sim3_adjoint": (g,)}[op]
    a, b = _both(getattr(jl, op), getattr(tl, op), *args)
    np.testing.assert_allclose(b, a, atol=ATOL)


def test_from_matrix_np_matches():
    g = np.asarray(jl.exp(jnp.asarray(_rand(6, 16, 6, 0.7))))
    T = np.asarray(jl.to_matrix(jnp.asarray(g))).astype(np.float64)
    for Ti in T:
        a = jl.from_matrix_np(Ti)
        b = tl.from_matrix_np(Ti)
        np.testing.assert_allclose(b, a, atol=ATOL)
    np.testing.assert_allclose(tl.inv_matrix_np(g), jl.inv_matrix_np(g),
                               atol=ATOL)
