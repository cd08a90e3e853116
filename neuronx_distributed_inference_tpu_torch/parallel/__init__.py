"""Parameter layout helpers of the port (counterpart:
``neuronx_distributed_inference_tpu/parallel/``)."""
