"""Hand-written CUDA kernels of the port (sources in ../../csrc), each
with its plain PyTorch version beside it. Nothing is built or imported
from CUDA until a kernel is first launched on a CUDA tensor."""
