"""Test-only comparison of the port's gradients with the JAX package's."""

import numpy as np


def assert_grads_match(got: dict, want: dict, rel: float = 1e-5) -> None:
    """``got`` (flat name -> torch gradient) against ``want`` (flat name ->
    numpy gradient, the same names): each leaf within ``rel`` of its norm,
    ``rel`` itself where the norm is under 1.  Checks the gradients'
    scale, which an Adam step's update (lr * g / |g| at the first step)
    does not."""
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert g is not None, name
        atol = rel * max(float(np.linalg.norm(want[name])), 1.0)
        np.testing.assert_allclose(g.numpy(), want[name], atol=atol,
                                   err_msg=name)
