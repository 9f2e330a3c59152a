"""PyTorch/CUDA port of the video frame interpolation framework.

A second package beside ``videoframeinterpolation_tpu`` (the JAX reference,
which stays unchanged). Module paths and class names mirror the JAX
package's, so each counterpart is easy to find; inside, the code is plain
PyTorch: ``nn.Module``s, functions on tensors and an explicit device.

Conventions kept from the reference, so the two compare like with like:
  * images and feature maps are NHWC at every public function of ``ops/``
    and ``nn/`` (convolutions see a channels-last NCHW view of the same
    memory, so no copy is made);
  * flows are ``(..., 2)`` as ``(fx, fy)`` in pixel units;
  * ``t`` is shaped ``(B, 1, 1, 1)``.

The package imports ``torch``, ``numpy`` and the standard library only.
Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
the CPU runs each hand-written kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
