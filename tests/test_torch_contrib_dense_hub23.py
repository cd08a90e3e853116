"""The contrib hub's later-wave dense families of the port (HunYuan-Dense,
BLOOM, MPT, Persimmon, openai-gpt, Apertus) against the JAX package's, on
the contiguous app, through the checks and the tiny reference configs of
test_torch_contrib_dense.py: specs field for field, converted trees leaf
for leaf, fp32 logits at atol=2e-3, rtol=1e-3 and greedy tokens
identical, and each knob's control (ALiBi, the embeddings' norm, the q/k
norm after RoPE and as a LayerNorm, the post-residual norms and the
missing final norm, xIELU) parting from JAX when the knob is removed."""

import pytest

from test_torch_contrib_dense import (HUB23, _no_tf32,  # noqa: F401
                                      check_contiguous, check_spec_and_tree,
                                      save_ckpts)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return save_ckpts(tmp_path_factory, HUB23)


@pytest.mark.parametrize("name", HUB23)
def test_spec_and_converter_match_jax(ckpts, name):
    check_spec_and_tree(ckpts, name)


@pytest.mark.parametrize("name", HUB23)
def test_contiguous_logits_and_greedy_match_jax(ckpts, name):
    check_contiguous(ckpts, name)
