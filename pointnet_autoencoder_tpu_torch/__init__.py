"""pointnet_autoencoder_tpu_torch: the PyTorch and CUDA port of the
point-cloud autoencoder framework, for NVIDIA Hopper (H100).

The JAX package ``pointnet_autoencoder_tpu`` beside it is the reference;
this package imports nothing from it, and nothing of JAX. Each Pallas
kernel of the reference is a hand-written CUDA C++ kernel here
(``csrc/*.cu``), built with ``nvcc`` for ``sm_90a`` at first use and bound
through ``ctypes``; every kernel has a plain PyTorch version beside it in
the same module, which is what runs on CPU tensors.

Ported so far, for every ``--model`` of the reference (``model``,
``model_cpu``, ``model_emd``, ``model_hierachy``, ``model_upconv``,
``model_fc_upconv``; ``models/registry.py``):

- serving: ``cli/serve.py`` -> ``serve.PointServer`` ->
  ``inference.InferenceSession`` -> ``models.PointAutoencoder`` eval, with
  the whole-encoder eval kernel (``ops/fused_encoder.py``) and the Chamfer
  forward kernel (``ops/chamfer.py``);
- training, host input, one card: ``cli/train.py`` -> ``train/loop.Trainer``
  -> ``PointAutoencoder(train=True)`` -> the model's loss, backward, Adam,
  with the conv5 head's forward and backward kernels
  (``ops/fused_head.py``), the Chamfer gradient kernel (``ops/chamfer.py``;
  ``model_cpu`` runs the dense Chamfer instead) or the approximate-EMD
  kernel (``ops/emd.py``), and training BatchNorm with its ReLU
  (``ops/batch_norm.py``); its eval epoch runs the serving kernels;
- ``cli/parity.py``: the reference README's 201-epoch command, recorded
  in ``docs/RESULTS_TORCH.md``;
- data parallelism (``parallel/mesh.py``): training on k ranks over
  ``torch.distributed`` with global-batch BatchNorm, and serving from a
  model replica per card.
"""

__version__ = "0.1.0"
