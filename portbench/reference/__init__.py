"""The plain reference the benchmark holds the port against: a float32
Llama/Qwen-style decoder (``model``) and back-end-first SSD / FiCABU with
the depth profile S(l) (``ficabu``), in plain PyTorch with TF32 off. It
imports nothing of the port, of ``jax`` or of the JAX package, and takes
no tensor the program made except the outputs it judges."""
