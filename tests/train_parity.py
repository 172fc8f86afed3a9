"""Shared helpers of the training parity tests (``test_torch_train_*``).

A train state is built once in the reference's form (numpy leaves) and
copied into the port (``from_reference_params`` and
``adamw.from_reference_state``), so both packages start from the same
bits.  States are compared leaf by leaf in the reference's flatten
order, with the checkpoint managers' path strings, which must agree
too.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from port_parity import CPU

from repro.checkpoint import manager as jmanager
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import manager
from repro_torch.models import dlrm, gnn, transformer
from repro_torch.optim import adamw


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def moments_at(params, opt_cfg, step: int = 200, seed: int = 0,
               v_range=(1e-7, 1e-6)) -> dict:
    """The reference's optimizer state at ``step`` for ``params`` (numpy
    tree): m ~ N(0, 1e-3^2), v ~ U(``v_range``), so that an update is
    smooth in the gradient (zero moments make ``m/sqrt(v)`` a sign); int8
    ``QTensor``s when ``opt_cfg.quantize_moments``."""
    rng = np.random.default_rng(seed)

    def draw(p, kind):
        shape = np.shape(p)
        x = (rng.normal(scale=1e-3, size=shape) if kind == "m"
             else rng.uniform(*v_range, size=shape)).astype(np.float32)
        if opt_cfg.quantize_moments:
            return np_tree(jadamw._quantize(jnp.asarray(x), opt_cfg.q_block,
                                            opt_cfg.q_row_mult))
        return x

    return {"m": jax.tree.map(lambda p: draw(p, "m"), params),
            "v": jax.tree.map(lambda p: draw(p, "v"), params),
            "step": np.int32(step)}


def port_params(family: str, cfg, params, **kw) -> dict:
    """The port's parameter tree holding the reference's ``params``."""
    if family == "lm":
        return transformer.param_tree(
            transformer.from_reference_params(cfg, params, device=CPU))
    if family == "gnn":
        return gnn.param_tree(gnn.from_reference_params(cfg, params,
                                                        device=CPU, **kw))
    return dlrm.param_tree(dlrm.from_reference_params(cfg, params,
                                                      device=CPU))


def port_state(family: str, cfg, ref_state: dict, **kw) -> dict:
    return {"params": port_params(family, cfg, ref_state["params"], **kw),
            "opt": adamw.from_reference_state(ref_state["opt"], device=CPU)}


def leaves(state, port: bool):
    """(paths, numpy leaves) in the reference's flatten order."""
    if port:
        paths, xs = manager._flatten_with_paths(state)
        return paths, [x.detach().float().numpy() if x.dtype == torch.bfloat16
                       else x.detach().numpy() for x in xs]
    paths, xs, _ = jmanager._flatten_with_paths(state)
    return paths, [np.asarray(x, np.float32) if x.dtype.name == "bfloat16"
                   else np.asarray(x) for x in xs]


def assert_states_close(got, want, tol: dict, q_tol: int = 0) -> None:
    """Every leaf of the port's state ``got`` against the reference's
    ``want``: the same paths; float leaves within ``tol`` (a dict of
    path fragment -> (rtol, atol), the first fragment in the path wins);
    int8 leaves within ``q_tol``; other integer leaves exact."""
    gp, gx = leaves(got, port=True)
    wp, wx = leaves(want, port=False)
    assert gp == wp
    for path, a, b in zip(gp, gx, wx):
        assert a.shape == b.shape, (path, a.shape, b.shape)
        if b.dtype == np.int8:
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert int(d.max(initial=0)) <= q_tol, (path, int(d.max()))
        elif np.issubdtype(b.dtype, np.integer):
            assert np.array_equal(a, b), path
        else:
            rtol, atol = next(v for k, v in tol.items() if k in path)
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=path)
