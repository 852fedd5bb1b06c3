"""pointnet_autoencoder_tpu_torch: the PyTorch and CUDA port of the
point-cloud autoencoder framework, for NVIDIA Hopper (H100).

The JAX package ``pointnet_autoencoder_tpu`` beside it is the reference;
this package imports nothing from it, and nothing of JAX. Each Pallas
kernel of the reference is a hand-written CUDA C++ kernel here
(``csrc/*.cu``), built with ``nvcc`` for ``sm_90a`` at first use and bound
through ``ctypes``; every kernel has a plain PyTorch version beside it in
the same module, which is what runs on CPU tensors.

Ported so far, for ``--model model``:

- serving: ``cli/serve.py`` -> ``serve.PointServer`` ->
  ``inference.InferenceSession`` -> ``models.PointAutoencoder`` eval, with
  the whole-encoder eval kernel (``ops/fused_encoder.py``) and the Chamfer
  forward kernel (``ops/chamfer.py``);
- training, host input, one card: ``cli/train.py`` -> ``train/loop.Trainer``
  -> ``PointAutoencoder(train=True)`` -> ``chamfer_x100_loss``, backward,
  Adam, with the conv5 head's forward and backward kernels
  (``ops/fused_head.py``) and the Chamfer gradient kernel
  (``ops/chamfer.py``); its eval epoch runs the serving kernels.
"""

__version__ = "0.1.0"
