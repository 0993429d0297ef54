"""The plain reference of the benchmark's configurations: plain PyTorch
and NumPy, imports nothing of the program under test (`stitchax_torch`)
and reads the tracked weights itself. Most modules are frozen copies of
the port's plain code paths (the kernels' plain versions in place of
K1, K3 and K4); `nets`, `train` and `evaluate` are the reference's own."""
