"""The port's seg train step at batch 2 against the JAX package's on the
CPU: one ``make_train_step`` step on two images (each loss term, every
gradient, every parameter after the update), with the draws of
``tests/test_torch_train.py`` for two images handed to both.

At batch 2 ``msdeform_impl='auto'`` routes both packages' deformable core
to ``flat``: JAX's ``_flat_level`` with its hand-written VJP, the port's
``FlatLevel`` on the plain versions of B7 and B8. The matcher solves each
image's assignment, the mask losses normalise by the valid targets of the
whole batch. Tiny config, tolerances and helpers of
``tests/test_torch_train.py``; a file of its own so that pytest-xdist's
``--dist loadfile`` can run its JAX compile on another worker than that
file's.
"""

import pytest

from tests.test_torch_train import step_matches_jax
from tests.test_torch_xdecoder import tiny_models


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def test_train_step_at_batch_2_matches_jax(models):
    step_matches_jax(models, b=2)
