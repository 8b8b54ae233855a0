"""LM model zoo of the port: the dense and VLM decoder families so far."""
