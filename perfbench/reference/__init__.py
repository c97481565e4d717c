"""The frozen plain reference of the benchmark's cells. It imports
neither JAX nor the JAX package nor the PyTorch port: ``frozen/`` holds
copies of the port's modules that these cells run, with every hand
kernel replaced by its plain PyTorch version (differentiated by
autograd), and the optimizers and the comparisons here are written out
in plain PyTorch."""
