"""``--model pcn_emd`` (PCN) on the CPU at a small size against its plain
reference (``benchmark/reference/pcn_emd.py``): B=2, 64 input points, 16 coarse
points on a 2 x 2 grid, 64 fine points, the published widths. The
forward, both loss terms, every gradient and three Adam steps; the
folding's tiling order; alpha and the learning rate across their
boundaries from the step counter; (input, target) pairs through the step
and the Trainer; the paths that refuse the family; the matmul count."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu_torch.cli import train as cli
from pointnet_autoencoder_tpu_torch.data import synthetic
from pointnet_autoencoder_tpu_torch.inference import InferenceSession
from pointnet_autoencoder_tpu_torch.models.autoencoder import PCNAutoencoder
from pointnet_autoencoder_tpu_torch.models import registry
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
from pointnet_autoencoder_tpu_torch.nn.decoders import folding_grid
from pointnet_autoencoder_tpu_torch.parallel import sp
from pointnet_autoencoder_tpu_torch.train import checkpoint, schedules
from pointnet_autoencoder_tpu_torch.train.loop import make_step_fns
from pointnet_autoencoder_tpu_torch.train.state import (PairedBatch,
                                                        TrainState,
                                                        make_optimizer)
from pointnet_autoencoder_tpu_torch.utils import roofline

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
B, N, GRID, FINE = 2, 64, 2, 64
COARSE = FINE // GRID ** 2
START = 49999
CONFIG = {"num_point": N, "num_gt_point": FINE, "num_coarse": COARSE,
          "grid_size": GRID, "grid_scale": 0.05,
          "encoder_widths": [[128, 256], [512, 1024]],
          "coarse_widths": [1024, 1024], "folding_widths": [512, 512],
          "alpha": {"boundaries": [10000, 20000, 50000],
                    "values": [0.01, 0.1, 0.5, 1.0]},
          "optimizer": {"learning_rate": 1e-4, "decay_rate": 0.7,
                        "decay_steps": 50000, "lr_floor": 1e-6,
                        "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}}


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _load(os.path.join(REPO, "benchmark", "reference", "pcn_emd.py"),
            "pcn_reference")


def _lr():
    opt = CONFIG["optimizer"]
    return schedules.Staircase(opt["learning_rate"], opt["decay_rate"], 1,
                               opt["decay_steps"], floor=opt["lr_floor"])


def _model():
    """The port's PCN at the small size, in f32, on seeded weights of the
    scale a trained network has (biases not zero, so every term moves)."""
    model = PCNAutoencoder(N, COARSE, GRID)
    g = torch.Generator().manual_seed(3)
    model.load_state_dict({k: torch.randn(v.shape, generator=g) * 0.05
                           for k, v in model.state_dict().items()})
    return model


def _pairs(k=3):
    g = torch.Generator().manual_seed(5)
    return [PairedBatch(torch.rand(B, N, 3, generator=g) - 0.5,
                        torch.rand(B, FINE, 3, generator=g) - 0.5)
            for _ in range(k)]


@pytest.fixture(scope="module")
def steps():
    """Three steps of the port (``make_step_fns``, eager on the CPU) from
    step 49,999, so that the learning rate and alpha each cross a
    boundary, and beside each the reference's step from the port's state
    before it (its variables and Adam's moments): from the same weights,
    the two sides' nearest neighbours part after a step or two, and each
    later gradient with them. Also the first step's forward and
    gradients, and each side's variables after each step."""
    model = _model()
    pairs = _pairs()
    with torch.no_grad():
        fine, end_points = model(pairs[0][0])
    state = TrainState(model, make_optimizer("adam", model.parameters()),
                       _lr(), step=START)
    train_step, _ = make_step_fns(state, "pcn_emd",
                                  schedules.bn_momentum_schedule(B, 1000))
    port, reference, after, grads = [], [], [], None
    for i, pair in enumerate(pairs):
        slots = state.optimizer.state
        r = ref.PCNReference(
            CONFIG, {k: v.clone() for k, v in model.state_dict().items()},
            step=START + i, t=i, slots=None if i == 0 else {
                k: (slots[p]["exp_avg"], slots[p]["exp_avg_sq"])
                for k, p in model.named_parameters()})
        if i == 0:
            coarse_ref, fine_ref = r.forward(r.params, pair[0])
        port.append({k: float(v) for k, v in train_step(pair).items()})
        reference.append(r.train_step(*pair))
        if grads is None:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        after.append(({k: p.detach().clone()
                       for k, p in model.named_parameters()}, r.params))
    return dict(fine=fine, coarse=end_points["coarse"], fine_ref=fine_ref,
                coarse_ref=coarse_ref, port=port, reference=reference,
                grads=grads, after=after)


def test_forward_matches_the_reference(steps):
    # f32 on both sides; the port's padded folding GEMM sums in another
    # order, a few f32 ulps of clouds of unit scale.
    torch.testing.assert_close(steps["coarse"], steps["coarse_ref"],
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(steps["fine"], steps["fine_ref"],
                               rtol=0, atol=1e-6)


def test_loss_terms_match_the_reference(steps):
    # Step 1's EMD and sqrt-Chamfer, and the loss: the same f32 functions
    # summed in other orders (K6's and the nearest neighbours' plain
    # versions against the dense reference), within 1e-5 relative.
    port, reference = steps["port"][0], steps["reference"][0]
    assert port["emd_coarse"] == pytest.approx(reference["emd"], rel=1e-5)
    assert port["cd_fine"] == pytest.approx(reference["cd"], rel=1e-5)
    assert port["loss"] == pytest.approx(reference["loss"], rel=1e-5)
    assert port["alpha"] == 0.5 and port["learning_rate"] == pytest.approx(
        1e-4, rel=1e-6)


def test_every_gradient_matches_the_reference(steps):
    # Autograd through the port's losses against the reference's closed
    # forms: f32 rounding of sums of 10^2-10^5 terms, within 1e-5 of each
    # leaf's largest element.
    grads, reference = steps["grads"], steps["reference"][0]["grads"]
    assert sorted(grads) == sorted(reference)
    for k, g in grads.items():
        scale = float(reference[k].abs().max())
        assert float((g - reference[k]).abs().max()) <= 1e-5 * scale, k


def test_three_adam_steps_match_the_reference(steps):
    # Each step from the same state: its loss within 1e-5 (f32 sums in
    # other orders), the learning rate 7e-5 from step 50,000 and alpha 1
    # from 50,001, and every variable after it within 1e-6 of its norm
    # (Adam's update of f32 gradients that agree to 1e-5 of their leaf's
    # largest element).
    for port, reference in zip(steps["port"], steps["reference"]):
        assert port["loss"] == pytest.approx(reference["loss"], rel=1e-5)
    assert [p["alpha"] for p in steps["port"]] == [0.5, 0.5, 1.0]
    assert [p["learning_rate"] for p in steps["port"]] == pytest.approx(
        [1e-4, 7e-5, 7e-5], rel=1e-6)
    for ours, theirs in steps["after"]:
        for k, v in ours.items():
            assert float((v - theirs[k]).norm()) <= 1e-6 * float(
                theirs[k].norm()), k


def test_folding_tiles_as_pcn_and_adds_the_centre():
    grid = folding_grid(2, 0.05)
    # TF's meshgrid ("xy"): row i * 2 + j is (lin[j], lin[i]).
    assert torch.equal(grid, torch.tensor([[-0.05, -0.05], [0.05, -0.05],
                                           [-0.05, 0.05], [0.05, 0.05]]))
    model = _model()
    x = torch.rand(B, N, 3, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        fine, end_points = model(x)
        code, coarse = end_points["embedding"], end_points["coarse"]
        fold = model.folding
        for row in (0, 5, FINE - 1):
            c, k = divmod(row, GRID ** 2)
            feat = torch.cat([grid[k], coarse[1, c], code[1]])
            out = fold.conv3(fold.conv2(fold.conv1(feat[None])))[0]
            torch.testing.assert_close(fine[1, row], out + coarse[1, c],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("step,alpha,lr", [
    (9999, 0.01, 1e-4), (10000, 0.01, 1e-4), (10001, 0.1, 1e-4),
    (19999, 0.1, 1e-4), (20000, 0.1, 1e-4), (20001, 0.5, 1e-4),
    (49999, 0.5, 1e-4), (50000, 0.5, 7e-5), (50001, 1.0, 7e-5)])
def test_alpha_and_learning_rate_across_boundaries(step, alpha, lr):
    # TF's piecewise_constant: values[i] while step <= boundaries[i]; the
    # staircase decays at multiples of 50,000 steps.
    model = _model()
    state = TrainState(model, make_optimizer("adam", model.parameters()),
                       _lr(), step=step)
    train_step, _ = make_step_fns(state, "pcn_emd",
                                  schedules.bn_momentum_schedule(B, 1000))
    out = train_step(_pairs(1)[0])
    r = ref.PCNReference(CONFIG, model.state_dict(), step=step)
    assert float(out["alpha"]) == pytest.approx(alpha, rel=1e-7)
    assert float(out["alpha"]) == schedules.pcn_alpha_schedule().f32(step)
    assert float(out["alpha"]) == pytest.approx(r.alpha(), rel=1e-7)
    assert float(out["learning_rate"]) == pytest.approx(lr, rel=1e-6)
    assert float(out["learning_rate"]) == pytest.approx(r.learning_rate(),
                                                        rel=1e-6)
    assert state.step == step + 1


@pytest.mark.parametrize("name", ["model", "model_emd"])
def test_a_pair_of_one_cloud_steps_as_the_cloud_alone(name):
    # A batch that is its own label, given as a pair of itself, takes the
    # same step bit for bit.
    batch = torch.rand(4, 64, 3, generator=torch.Generator().manual_seed(2))
    runs = []
    for given in (batch, PairedBatch(batch, batch)):
        model = get_model_spec(name).make(
            64, generator=torch.Generator().manual_seed(0))
        state = TrainState(model, make_optimizer("adam", model.parameters()),
                           schedules.learning_rate_schedule(1e-3, 0.7, 4,
                                                            200000))
        train_step, eval_step = make_step_fns(
            state, name, schedules.bn_momentum_schedule(4, 200000))
        out = [train_step(given) for _ in range(2)]
        out.append(eval_step(given))
        runs.append((out, model.state_dict()))
    (a, sa), (b, sb) = runs
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_the_pair_halves_by_rows():
    pair = _pairs(1)[0]
    half = pair[:1]
    assert isinstance(half, PairedBatch) and half.shape == (1, N, 3)
    assert torch.equal(half[1], pair[1][:1])


@pytest.mark.parametrize("gt, want", [(None, 16384), (8192, 8192),
                                     (1024, 1024), (512, None)])
def test_num_gt_point_sizes_the_target_alone(gt, want):
    # The network keeps PCN's 1024 coarse points on a 4 x 4 grid whatever
    # the target's size; a target below the coarse cloud is refused.
    spec = get_model_spec("pcn_emd")
    if want is None:
        with pytest.raises(ValueError, match="num_gt_point=512"):
            spec.gt_points(gt)
        return
    assert spec.gt_points(gt) == want
    model = spec.make(2048)
    assert (model.num_coarse, model.num_fine) == (1024, 16384)
    assert model.folding.grid_size == 4


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data") / "fixture")
    return synthetic.write_fixture(root, 14, 256, categories=["Chair"])


@pytest.fixture
def small_pcn(monkeypatch):
    """``--model pcn_emd`` at 16 coarse points on its 4 x 4 grid (256 fine
    points) in place of the published 1024, so the CLI trains in seconds
    on the CPU."""
    spec = dataclasses.replace(get_model_spec("pcn_emd"), fold=(16, 4))
    monkeypatch.setitem(registry._REGISTRY, "pcn_emd", spec)


def _argv(root, log_dir, *extra):
    return ["--model", "pcn_emd", "--data_path", root, "--category",
            "Chair", "--num_point", "64", "--num_gt_point", "256",
            "--batch_size", "2", "--log_dir", log_dir, "--log_every", "2",
            "--device", "cpu", "--learning_rate", "1e-4", "--decay_step",
            "50000", "--lr_floor", "1e-6", *extra]


def test_cli_trains_pcn_and_resumes(fixture_root, tmp_path, small_pcn):
    log_dir = str(tmp_path / "log")
    assert cli.main(_argv(fixture_root, log_dir, "--max_epoch", "1")) == 0
    with open(os.path.join(log_dir, "log_train.txt")) as f:
        text = f.read()
    for line in ("mean emd_coarse: ", "mean cd_fine: ",
                 "eval mean emd_coarse: ", "Model saved in file: "):
        assert line in text, line
    assert "mean pc loss" not in text
    tree = checkpoint.load(os.path.join(log_dir, "model.ckpt"))
    assert tree["step"] > 0 and tree["epoch"] == 1
    assert tree["model"]["folding.conv1.dense.weight"].shape == (512, 1029)
    assert tree["model"]["coarse.fc3.dense.weight"].shape == (3 * 16, 1024)
    ended = []
    assert cli.main(_argv(fixture_root, log_dir, "--max_epoch", "2",
                          "--resume"), after=ended.append) == 0
    trainer, = ended
    assert trainer.start_epoch == 1
    assert trainer.state.step == 2 * tree["step"]
    assert np.isfinite(trainer.best_loss)


@pytest.mark.parametrize("path", ["serving", "tensor parallelism",
                                  "point parallelism", "sp_loss_fn"])
def test_paths_that_refuse_pcn_name_it(path, fixture_root, tmp_path,
                                       small_pcn):
    with pytest.raises(ValueError, match="pcn_emd"):
        if path == "serving":
            InferenceSession("pcn_emd", os.path.join(tmp_path, "none.pt"),
                             64, device="cpu")
        elif path == "sp_loss_fn":
            sp.sp_loss_fn("pcn_emd", None)
        else:
            flag = ("--model_parallel" if path == "tensor parallelism"
                    else "--point_parallel")
            extra = [flag, "2"] if flag == "--model_parallel" else [
                flag, "--data_parallel", "2"]
            cli.run(cli.build_parser().parse_args(_argv(
                fixture_root, str(tmp_path / "log"), *extra)))


def test_matmul_count_is_what_one_step_runs():
    # StepCost counts every matmul of one eager step; the folding's first
    # layer runs over its rows padded with 3 zero columns (1032 wide), the
    # count is PCN's 1029.
    model = _model()
    state = TrainState(model, make_optimizer("adam", model.parameters()),
                       _lr(), step=START)
    spec = get_model_spec("pcn_emd")
    pair = _pairs(1)[0]
    bn = schedules.bn_momentum_schedule(B, 1000)
    state.train_step(pair, spec.loss_fn, bn)
    with roofline.StepCost() as cost:
        state.train_step(pair, spec.loss_fn, bn)
    count = roofline.pcn_step_matmul_flops(B, N, COARSE, GRID)
    pad = 3 * 2.0 * B * FINE * 3 * 512
    assert cost.matmul_flops == {"float32": count["network"] + pad}
    parts = {p: cost.part(p)["flops"] for p in ("encoder", "coarse",
                                                "folding")}
    # The parts hold their forward's products.
    assert parts["encoder"] == sum(
        2.0 * B * N * i * o for i, o in ((3, 128), (128, 256), (512, 512),
                                         (512, 1024)))
    assert parts["coarse"] == count["coarse"] / 3
    assert parts["folding"] == (count["folding"] + pad) / 3
    assert set(cost.kernels) == {"emd_forward", "nn_distance",
                                 "nn_distance_grad"}
