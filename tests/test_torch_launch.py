"""Scheduler-launched groups: ``parallel.mesh.initialize_distributed_if_requested``
under SLURM's and Open MPI's variables, against jax's own detectors
(``jax/_src/clusters``), which the JAX package's hook hands them to
(``pointnet_autoencoder_tpu/parallel/mesh.py``). On the CPU, over gloo.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax._src.clusters.ompi_cluster import OmpiCluster
from jax._src.clusters.slurm_cluster import SlurmCluster

from pointnet_autoencoder_tpu_torch.parallel import mesh

import torch_dp_workers as workers

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_VARS = (mesh.LAUNCHER_ENV + mesh.SLURM_ENV + mesh.OMPI_ENV
               + (mesh.PRTE_MARKER,))


@pytest.fixture
def bare(monkeypatch):
    """No launcher's variables; ``init_process_group`` must not run."""
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    return calls


def _slurm(monkeypatch, nodelist="node001", job_id="1234567", ntasks="4",
           procid="2", localid="1"):
    for var, value in zip(mesh.SLURM_ENV,
                          (job_id, nodelist, ntasks, procid, localid)):
        monkeypatch.setenv(var, value)


def test_no_scheduler_touches_nothing(bare):
    assert mesh.find_rendezvous() is None
    assert mesh.initialize_distributed_if_requested("cpu") is False
    assert bare == [] and not dist.is_initialized()


@pytest.mark.parametrize("nodelist", [
    "node001", "node001,host2", "node[001-0015],host2",
    "node[001,007-015],host2", "gpu-a[12-13]", "localhost"])
@pytest.mark.parametrize("job_id", ["1234567", "4095", "0"])
def test_slurm_coordinator_is_jax_s(monkeypatch, bare, nodelist, job_id):
    _slurm(monkeypatch, nodelist=nodelist, job_id=job_id)
    assert SlurmCluster.is_env_present()
    assert mesh.slurm_coordinator() == \
        SlurmCluster.get_coordinator_address(None, None)


@pytest.mark.parametrize("uri", [
    "1531576320.0;tcp://10.96.0.1,10.148.0.1,10.108.0.1:34911",
    "1531576320.0;tcp://10.96.0.1:34911",
    "1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,2620:10d:c083:150e::"
    "3000:2]:43370",
    "4096.0;tcp6://[::1]:5000"])
def test_ompi_coordinator_is_jax_s(monkeypatch, bare, uri):
    monkeypatch.setenv("OMPI_MCA_orte_hnp_uri", uri)
    assert mesh.ompi_coordinator() == \
        OmpiCluster.get_coordinator_address(None, None)


def test_the_rendezvous_of_each_scheduler(monkeypatch, bare):
    _slurm(monkeypatch, nodelist="node[003-004]", job_id="77")
    assert mesh.find_rendezvous() == mesh.Rendezvous(
        "SLURM", f"tcp://node003:{77 + 61440}", 4, 2, 1)
    # mpirun inside an allocation: Open MPI's variables name the ranks,
    # as jax tries Open MPI first.
    for var, value in zip(mesh.OMPI_ENV, (
            "1314521088.0;tcp6://[fe80::1,2620::2]:43370", "8", "5", "1")):
        monkeypatch.setenv(var, value)
    port = 1314521088 // 4096 % 4096 + 61440
    assert mesh.find_rendezvous() == mesh.Rendezvous(
        "Open MPI", f"tcp://[fe80::1]:{port}", 8, 5, 1)
    # torchrun's variables come first of all.
    for var, value in zip(mesh.LAUNCHER_ENV,
                          ("3", "6", "0", "10.0.0.1", "1234")):
        monkeypatch.setenv(var, value)
    assert mesh.find_rendezvous() == mesh.Rendezvous(
        "torchrun", "env://", 6, 3, 0)
    assert mesh.initialize_distributed_if_requested("cpu") is True
    assert bare == [(("gloo",), {"init_method": "env://", "world_size": 6,
                                 "rank": 3})]


@pytest.mark.parametrize("missing", mesh.SLURM_ENV[1:])
def test_a_partial_slurm_environment_raises(monkeypatch, bare, missing):
    _slurm(monkeypatch)
    monkeypatch.delenv(missing)
    with pytest.raises(RuntimeError, match=f"SLURM: .* {missing} missing.*"
                                           f"MASTER_PORT"):
        mesh.initialize_distributed_if_requested("cpu")
    assert bare == []


@pytest.mark.parametrize("missing", mesh.OMPI_ENV[1:])
def test_a_partial_open_mpi_environment_raises(monkeypatch, bare, missing):
    for var, value in zip(mesh.OMPI_ENV,
                          ("4096.0;tcp://10.0.0.2:5000", "2", "0", "0")):
        monkeypatch.setenv(var, value)
    monkeypatch.delenv(missing)
    with pytest.raises(RuntimeError, match=f"Open MPI: .* {missing} missing"):
        mesh.initialize_distributed_if_requested("cpu")
    assert bare == []


def test_prte_alone_raises(monkeypatch, bare):
    """Open MPI 5 (PRRTE): the JAX package's hook hands it to a detector
    that jax 0.9.0 lacks."""
    monkeypatch.setenv("PRTE_LAUNCHED", "1")
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "0")
    with pytest.raises(RuntimeError, match="PRTE_LAUNCHED.*RANK, "
                                           "WORLD_SIZE, LOCAL_RANK"):
        mesh.initialize_distributed_if_requested("cpu")
    assert bare == []


def _free_job_id() -> int:
    """A SLURM job id whose derived port (id % 4096 + 61440) is free
    here now."""
    rng = np.random.RandomState(os.getpid())
    for port in rng.permutation(np.arange(61440, 65536)):
        with socket.socket() as s:
            try:
                s.bind(("", int(port)))
            except OSError:
                continue
        return int(port) - 61440
    raise RuntimeError("no free port in 61440-65535")


def test_a_gloo_world_of_one_joins_under_slurm(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    _slurm(monkeypatch, nodelist="localhost", job_id=str(_free_job_id()),
           ntasks="1", procid="0", localid="0")
    assert not dist.is_initialized()
    try:
        assert mesh.initialize_distributed_if_requested("cpu") is True
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        assert dist.get_backend() == "gloo"
        x = torch.arange(3.0)
        dist.all_reduce(x)
        assert torch.equal(x, torch.arange(3.0))
        # A second call finds the group and joins nothing more.
        assert mesh.initialize_distributed_if_requested("cpu") is True
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_a_busy_slurm_port_names_itself(monkeypatch):
    """The port derived from the job id is taken: rank 0 cannot listen,
    and the error says which port and what to export instead."""
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    job_id = _free_job_id()
    with socket.socket() as busy:
        busy.bind(("", job_id + 61440))
        busy.listen()
        _slurm(monkeypatch, nodelist="localhost", job_id=str(job_id),
               ntasks="1", procid="0", localid="0")
        with pytest.raises(RuntimeError, match=f"{job_id + 61440}.*free "
                                               f"MASTER_PORT"):
            mesh.initialize_distributed_if_requested("cpu")
    assert not dist.is_initialized()


def test_two_ranks_launched_as_srun_launches_them(tmp_path):
    """Two processes with SLURM's variables and nothing else: they join
    one gloo group. ``make_step_fns(..., group)`` on each rank's 4 rows
    equals the step of all 8 alone (loss rtol 1e-5, BN statistics rtol
    1e-4 atol 1e-6, parameters within 2 x the learning rate: Adam's first
    step moves an entry by about +-lr), the ranks' states are bit-equal,
    and the benchmark prints from rank 0 alone, for 2 chips."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env.update(PYTHONPATH=ROOT, SLURM_JOB_ID=str(_free_job_id()),
               SLURM_STEP_NODELIST="localhost", SLURM_NTASKS="2",
               BENCH_NUM_POINT="128", BENCH_ITERS_SCALE="0.02",
               BENCH_BUDGET_S="0",
               BENCH_SELF_PATH=str(tmp_path / "BENCH_SELF.json"))
    script = os.path.join(ROOT, "tests", "torch_dp_workers.py")
    procs = [subprocess.Popen(
        [sys.executable, script, "scheduled_rank", str(tmp_path)],
        env=dict(env, SLURM_PROCID=str(r), SLURM_LOCALID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    ranks = workers.load_ranks(str(tmp_path), 2)
    for r, res in enumerate(ranks):
        assert res["joined"] and res["rank"] == r and res["world"] == 2
        assert res["backend"] == "gloo"
    got, want = ranks[0]["group"], ranks[0]["alone"]
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for key in ("loss", "pcloss"):
        np.testing.assert_allclose(got["metrics"][key],
                                   want["metrics"][key], rtol=1e-5)
    for key in ("learning_rate", "bn_decay"):
        assert got["metrics"][key] == want["metrics"][key]
    for name, value in got["state"].items():
        tol = ((1e-4, 1e-6) if name.endswith(("mean", "var"))
               else (0, 2e-3))
        np.testing.assert_allclose(value.numpy(),
                                   want["state"][name].numpy(),
                                   rtol=tol[0], atol=tol[1], err_msg=name)
        assert torch.equal(value, ranks[1]["group"]["state"][name]), name
    assert ranks[0]["group"]["metrics"] == ranks[1]["group"]["metrics"]
    lines = [json.loads(x) for x in outs[0][0].splitlines()]
    assert outs[1][0] == ""
    assert lines and lines[-1]["metric"] == "train_throughput_model_b32_n128"
    extras = lines[-1]["extras"]
    assert extras["device"] == {"kind": "cpu", "count": 2}
    assert extras["group"] == {"backend": "gloo", "ranks": 2}
    assert extras["skipped"] == ["model_emd", "serving", "serving_b1",
                                 "families", "serving_b512"]
    assert extras["roofline"]["model"]["measured_ms"] == \
        extras["model_step_ms"]
    with open(tmp_path / "BENCH_SELF.json") as f:
        assert json.loads(f.read()) == lines[-1]
