"""Model configurations (reference: ``hcache_deepspeed_tpu/models``)."""
