"""Models of the port: the quantized, fanin-prunable MLP and the LM
stack (``layers``, ``mamba``, ``lm``)."""
