"""Checkpoint and parameter utilities of the port (counterpart:
``neuronx_distributed_inference_tpu/utils/``)."""
