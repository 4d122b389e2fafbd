"""Model zoo of the port: the layer library, the transformer block and
GPT-2."""
