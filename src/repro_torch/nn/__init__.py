"""Functional modules: params are plain dicts of tensors and
QuantizedTensors."""
