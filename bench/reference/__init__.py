"""Plain PyTorch references of the benchmark's models: float32, TF32 off,
no kernel, plan, batch bucket or graph of the program.  Nothing here imports
``repro_torch``; the weights are the HWIO kernels the benchmark made."""
