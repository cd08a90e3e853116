"""KV cache and bucketing modules of the port (counterpart:
``neuronx_distributed_inference_tpu/modules/``)."""
