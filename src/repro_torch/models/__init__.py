"""The LM of the port: layers, attention with its kernels, ``DecoderLM``."""
