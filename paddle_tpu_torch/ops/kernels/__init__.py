"""Hand-written Hopper kernels, one module each, beside a plain PyTorch
version of the same math. Sources are in csrc/; _build.py compiles them
with nvcc at first use. Nothing here imports a compiler or builds at
import time."""
