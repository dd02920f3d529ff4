"""Models of the port: the quantized, fanin-prunable MLP."""
