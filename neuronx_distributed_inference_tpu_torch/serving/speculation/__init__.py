"""Speculative decoding of the port (counterpart:
``neuronx_distributed_inference_tpu/serving/speculation/``). Only the
sampling-mode check the ragged path shares is ported; the proposers and
the speculative decode path wait (the adapters refuse ``speculation=``)."""

from .verifier import validate_spec_sampling

__all__ = ["validate_spec_sampling"]
