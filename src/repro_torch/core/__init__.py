"""SPx codebooks and the QuantizedTensor container."""
