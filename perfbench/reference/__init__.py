"""Plain PyTorch reference of each model part, in float32 or float64.

Imports nothing of ``cmdiad_tpu_torch``, ``cmdiad_tpu`` or JAX: every
function takes the benchmark's own weights (checkpoint-named state dicts
of tensors), parts and fitted state.
"""
