"""Checkpoint loading in the port against the JAX package: a tiny Llama
saved locally with ``transformers`` (safetensors) loads through both
packages' ``load_weights`` and gives the same greedy tokens and fp32
logits at atol=2e-3, rtol=1e-3 (the suite's HF tolerance)."""

import numpy as np
import pytest
import torch

from conftest import tiny_llama_hf_config
from test_torch_paged_app import HD64, LOGIT_TOL, _prompts, _tcfg
from neuronx_distributed_inference_tpu.config import TpuConfig as JTpuConfig
from neuronx_distributed_inference_tpu.config import \
    load_pretrained_config as j_load_pretrained_config
from neuronx_distributed_inference_tpu.models.application import \
    PagedCausalLMApplication as JPagedApp
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu_torch.config import (
    TpuConfig, load_pretrained_config)
from neuronx_distributed_inference_tpu_torch.models.application import \
    PagedCausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import \
    LlamaInferenceConfig


@pytest.fixture(scope="module")
def hd64_ckpt(tmp_path_factory):
    """The same tiny checkpoint as tests/test_decode_attention.py."""
    import os
    saved = {k: os.environ.get(k) for k in ("USE_TF", "USE_FLAX")}
    # the torch model needs neither TensorFlow nor Flax (importing them
    # triples transformers' import time)
    os.environ.update(USE_TF="0", USE_FLAX="0")
    try:
        from transformers import LlamaConfig, LlamaForCausalLM
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig(**tiny_llama_hf_config(**HD64)))
    model.eval()
    d = tmp_path_factory.mktemp("tiny_llama_hd64_port")
    model.save_pretrained(d, safe_serialization=True)
    return str(d)


def test_checkpoint_load_matches_jax(hd64_ckpt):
    jcfg = JLlamaConfig(JTpuConfig(**_tcfg(output_logits=True)),
                        load_config=j_load_pretrained_config(hd64_ckpt))
    japp = JPagedApp(hd64_ckpt, jcfg, JLlamaFamily).load_weights()
    tcfg = LlamaInferenceConfig(TpuConfig(**_tcfg(output_logits=True)),
                                load_config=load_pretrained_config(hd64_ckpt))
    tapp = PagedCausalLMApplication(hd64_ckpt, tcfg, device="cpu")
    tapp.load_weights()
    ids, mask = _prompts(2, [25, 11], seed=6)
    want = japp.init_cache().generate(ids, attention_mask=mask,
                                      max_new_tokens=4, return_logits=True)
    got = tapp.init_cache().generate(ids, attention_mask=mask,
                                     max_new_tokens=4, return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    for a, b in zip(got["logits"], want["logits"]):
        np.testing.assert_allclose(a, np.asarray(b), **LOGIT_TOL)
