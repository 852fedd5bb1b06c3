"""The plain reference of the benchmarked model: the published PointNet
autoencoder's forward, losses, gradients, Adam and BatchNorm statistics in
plain PyTorch (``model.py``, ``losses.py``). It imports nothing of the
program under test and nothing of JAX; it takes only the configuration,
the weights the benchmark made from the seed and the inputs."""
