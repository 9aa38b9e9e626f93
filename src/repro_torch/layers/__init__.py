"""LM layer primitives: dense/norm/embedding, RoPE, MLPs and attention."""
