"""cvpr2021_vspw_implement_tpu_torch — PyTorch / CUDA port for one NVIDIA H100.

A second package beside the JAX one (``cvpr2021_vspw_implement_tpu``),
which stays the reference: the port mirrors its module paths and holds
each ported piece to its JAX counterpart in ``tests/test_torch_*.py``.
Modules are ``nn.Module``s in NCHW; every TPU (Pallas) kernel on a ported
path is a CUDA kernel written by hand for Hopper (``kernels/csrc``), with
a plain PyTorch version beside it that is its oracle and its CPU path.

Entry points run on the card (``device="cuda"``) and raise when CUDA is
absent, unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
