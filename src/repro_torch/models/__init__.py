"""LM model zoo of the port: the dense, MoE, VLM, RWKV-6 (ssm) and Griffin
(hybrid) decoder families and the whisper encoder-decoder family."""
