"""Pipeline-parallel serving of the port (parallel/pp.py) on the CPU:
``PipelinedSession(devices=["cpu", "cpu"], num_microbatches=2)`` against
the port's unpipelined session and against the JAX package's
PipelinedSession on the same weights (the twin of
tests/test_inference.py's test_pipelined_session_matches_unpipelined and
tests/test_serve.py's test_server_over_pipelined_session), and
cli/serve.py's --pipeline_parallel, --num_microbatches and
--compilation_cache_dir; and the compiled stages' schedule under stand-in
programs that overwrite one static output buffer at every call, as a
replayed graph does.

Tolerance: rtol 1e-5, atol 1e-6, the JAX tests'.
"""

import types

import jax
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.cli import serve as jcli_serve
from pointnet_autoencoder_tpu.models.registry import get_model_spec as jspec
from pointnet_autoencoder_tpu.parallel.pp import PipelinedSession as JPipe
from pointnet_autoencoder_tpu_torch.cli import serve as cli_serve
from pointnet_autoencoder_tpu_torch.convert import from_flax_variables
from pointnet_autoencoder_tpu_torch.inference import InferenceSession
from pointnet_autoencoder_tpu_torch.parallel.pp import PipelinedSession
from pointnet_autoencoder_tpu_torch.serve import PointClient, PointServer

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
SIZES = {"model": 64, "model_hierachy": 128, "model_fc_upconv": 2048,
         "model_upconv": 2048}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Per model: JAX's init at its num_point, as the JAX module and
    variables and as the port's .pt state dict."""
    out = {}
    for name, n in SIZES.items():
        module, variables = jspec(name).init_variables(
            jax.random.PRNGKey(0), n, 4)
        path = str(tmp_path_factory.mktemp(name) / "w.pt")
        torch.save(from_flax_variables(jax.device_get(variables)), path)
        out[name] = (module, variables, path)
    return out


def _clouds(b, n, seed):
    return np.random.RandomState(seed).randn(b, n, 3).astype(np.float32)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_pipelined_session_matches_unpipelined(weights, name):
    """reconstruct (a ragged batch of 5 and one cloud), embed (stage 0
    alone) and decode (stage 1 alone) against the unpipelined session and
    the JAX package's PipelinedSession on the same weights."""
    module, variables, path = weights[name]
    n = SIZES[name]
    ref = InferenceSession(name, path, n, batch_size=4, device="cpu")
    pp = PipelinedSession(ref, devices=["cpu", "cpu"], num_microbatches=2)
    stand_in = types.SimpleNamespace(_model=module, _variables=variables,
                                     batch_size=4, model_name=name)
    jpp = JPipe(stand_in, devices=jax.devices()[:2], num_microbatches=2)
    batch = _clouds(5, n, 1)
    rec = pp.reconstruct(batch)
    np.testing.assert_allclose(rec, ref.reconstruct(batch), **TOL)
    np.testing.assert_allclose(rec, jpp.reconstruct(batch), **TOL)
    np.testing.assert_allclose(pp.reconstruct(batch[0]),
                               ref.reconstruct(batch[0]), **TOL)
    emb = pp.embed(batch)
    np.testing.assert_allclose(emb, ref.embed(batch), **TOL)
    np.testing.assert_allclose(emb, jpp.embed(batch), **TOL)
    np.testing.assert_allclose(pp.decode(emb), ref.decode(emb), **TOL)
    np.testing.assert_allclose(pp.decode(emb), jpp.decode(emb), **TOL)
    np.testing.assert_allclose(pp.decode(emb[0]), ref.decode(emb[0]), **TOL)


def test_pipelined_session_checks(weights):
    """The JAX package's refusals and messages: microbatches that do not
    divide the batch, a device count other than 2, bad inputs; the card
    by default, which this machine lacks."""
    _, _, path = weights["model"]
    ref = InferenceSession("model", path, 64, batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        PipelinedSession(ref, devices=["cpu", "cpu"], num_microbatches=3)
    with pytest.raises(ValueError, match="2 stage devices"):
        PipelinedSession(ref, devices=["cpu"] * 3)
    pp = PipelinedSession(ref, devices=["cpu", "cpu"], num_microbatches=4)
    with pytest.raises(ValueError, match="expected"):
        pp.reconstruct(np.zeros((2, 63, 3), np.float32))
    with pytest.raises(ValueError, match="0 input shapes"):
        pp.embed(np.zeros((0, 64, 3), np.float32))
    with pytest.raises(ValueError, match="nonempty"):
        pp.decode(np.zeros((0, 1024), np.float32))
    if torch.cuda.device_count() < 2:
        with pytest.raises((ValueError, RuntimeError)):
            PipelinedSession(ref)


def test_server_over_pipelined_session(weights):
    """PointServer accepts the pipelined session (what cli.serve
    --pipeline_parallel builds): results equal the unpipelined session
    across all three ops."""
    _, _, path = weights["model"]
    ref = InferenceSession("model", path, 64, batch_size=4, device="cpu")
    pp = PipelinedSession(ref, devices=["cpu", "cpu"], num_microbatches=2)
    srv = PointServer(pp, port=0, max_delay_ms=1.0).start()
    try:
        with PointClient("127.0.0.1", srv.port) as c:
            assert c.ping()["model"] == "model"
            pts = _clouds(3, 64, 5)
            np.testing.assert_allclose(c.reconstruct(pts),
                                       ref.reconstruct(pts), **TOL)
            emb = c.embed(pts)
            np.testing.assert_allclose(emb, ref.embed(pts), **TOL)
            np.testing.assert_allclose(c.decode(emb), ref.decode(emb),
                                       **TOL)
    finally:
        srv.stop()


def test_serve_cli_pipeline_flags(weights):
    """cli/serve.py has the JAX package's serving flags plus --device:
    --pipeline_parallel builds a PipelinedSession (on two CPU stages with
    --device cpu) with --num_microbatches microbatches, refuses
    --data_parallel beside it with the JAX message, and
    --compilation_cache_dir is refused by name."""
    _, _, path = weights["model"]
    ours = {a.dest for a in cli_serve.build_parser()._actions}
    theirs = {a.dest for a in jcli_serve.build_parser()._actions}
    assert ours == theirs | {"device"}
    parse = cli_serve.build_parser().parse_args
    base = ["--model_path", path, "--num_point", "64", "--batch_size", "4",
            "--device", "cpu", "--port", "0"]
    args = parse(base + ["--pipeline_parallel"])
    assert args.pipeline_parallel and args.num_microbatches == 4
    session, _ = cli_serve.build_server(parse(
        base + ["--pipeline_parallel", "--num_microbatches", "2"]))
    assert isinstance(session, PipelinedSession)
    assert [str(d) for d in session.devices] == ["cpu", "cpu"]
    assert session._mb == 2
    with pytest.raises(SystemExit, match="exclusive with --data_parallel"):
        cli_serve.build_server(parse(base + ["--pipeline_parallel",
                                             "--data_parallel", "2"]))
    with pytest.raises(NotImplementedError, match="compilation_cache_dir"):
        cli_serve.build_server(parse(base + ["--compilation_cache_dir",
                                             "/nonexistent/cache"]))


class StandInProgram:
    """A captured stage as a replay behaves: static inputs copied in, and
    one static output buffer that every replay overwrites in place."""

    def __init__(self, fn, inputs):
        self.fn = fn
        self.inputs = tuple(t.clone() for t in inputs)
        self.outputs = fn(*self.inputs).clone()

    def replay(self, *inputs):
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        self.outputs.copy_(self.fn(*self.inputs))
        return self.outputs


class StandInCache:
    """``utils/graphs.ProgramCache``'s calls, on the CPU."""

    def __init__(self):
        self.programs = {}
        self.warm_ups = 0

    def warm_up(self, fn):
        self.warm_ups += 1
        return fn()

    def program(self, key, fn, inputs=(), generators=()):
        if key not in self.programs:
            self.programs[key] = StandInProgram(fn, inputs)
        return self.programs[key]

    def close(self):
        self.programs.clear()


@pytest.mark.parametrize("first", ["reconstruct", "embed"])
@pytest.mark.parametrize("name", ["model", "model_hierachy"])
def test_compiled_stages_hand_over_before_stage_0_replays_again(weights,
                                                                name, first):
    """Stage 0 runs a microbatch ahead of stage 1 and its program
    overwrites its output at every replay: the embedding must reach stage
    1's static input, or stage 1's own tensor while stage 1 warms up,
    before stage 0 replays for the next microbatch. Two rounds of
    reconstruct, embed and decode, 4 microbatches of a ragged 7, equal the
    unpipelined session's and JAX's in every call. With ``embed`` first,
    the first reconstruct replays stage 0 while stage 1 warms up (a
    server whose first request is an embed)."""
    module, variables, path = weights[name]
    n = SIZES[name]
    ref = InferenceSession(name, path, n, batch_size=8, device="cpu")
    pp = PipelinedSession(ref, devices=["cpu", "cpu"], num_microbatches=4)
    assert pp.forward_path == "eager (the CPU runs eager)"
    caches = pp._programs = (StandInCache(), StandInCache())
    stand_in = types.SimpleNamespace(_model=module, _variables=variables,
                                     batch_size=8, model_name=name)
    jpp = JPipe(stand_in, devices=jax.devices()[:2], num_microbatches=4)
    batch = _clouds(7, n, 2)
    emb = ref.embed(batch)
    calls = {"reconstruct": lambda: pp.reconstruct(batch),
             "embed": lambda: pp.embed(batch),
             "decode": lambda: pp.decode(emb)}
    order = ([first] + [op for op in ("reconstruct", "embed", "decode")
                        if op != first])
    got = {op: [] for op in order}
    for _ in range(2):
        for op in order:
            got[op].append(calls[op]())
    # Stage 1 takes the same (mb, D) f32 input in reconstruct and decode.
    assert [c.warm_ups for c in caches] == [4, 4]
    assert [len(c.programs) for c in caches] == [1, 1]
    for rec in got["reconstruct"]:
        np.testing.assert_allclose(rec, ref.reconstruct(batch), **TOL)
        np.testing.assert_allclose(rec, jpp.reconstruct(batch), **TOL)
    for got_emb in got["embed"]:
        np.testing.assert_allclose(got_emb, emb, **TOL)
        np.testing.assert_allclose(got_emb, jpp.embed(batch), **TOL)
    for dec in got["decode"]:
        np.testing.assert_allclose(dec, ref.decode(emb), **TOL)
        np.testing.assert_allclose(dec, jpp.decode(emb), **TOL)
