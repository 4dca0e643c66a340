"""The port's WSEGAN step against the JAX one, continued from test_torch_wsegan_step.py
(its helpers, config and tolerances): the cost of vanilla_gan, the rows of the L1 term
and a masked row."""
import pytest

from test_torch_wsegan_step import MORE_CASES, check_one_step


@pytest.mark.parametrize("case", list(MORE_CASES))
def test_one_step_matches_jax_more_cases(case, tmp_path):
    check_one_step(*MORE_CASES[case], tmp_path)
