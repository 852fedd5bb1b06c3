"""pointnet_autoencoder_tpu_torch: the PyTorch and CUDA port of the
point-cloud autoencoder framework, for NVIDIA Hopper (H100).

The JAX package ``pointnet_autoencoder_tpu`` beside it is the reference;
this package imports nothing from it, and nothing of JAX. Each Pallas
kernel of the reference is a hand-written CUDA C++ kernel here
(``csrc/*.cu``), built with ``nvcc`` for ``sm_90a`` at first use and bound
through ``ctypes``; every kernel has a plain PyTorch version beside it in
the same module, which is what runs on CPU tensors.

Ported so far: the serving path of ``--model model``
(``cli/serve.py`` -> ``serve.PointServer`` -> ``inference.InferenceSession``
-> ``models.PointAutoencoder``), with the whole-encoder eval kernel
(``ops/fused_encoder.py``) and the Chamfer forward kernel
(``ops/chamfer.py``). Training waits for a later slice.
"""

__version__ = "0.1.0"
